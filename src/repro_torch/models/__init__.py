"""The paper's experiment models, the dense transformer (``layers``,
``attention``, ``transformer``) and the weight carrier to/from the
reference's parameter trees."""
