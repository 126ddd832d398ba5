"""The paper's experiment models, the decoder families (``layers``,
``attention``, ``moe``, ``ssm``, ``rglru``, ``transformer``) and the weight carrier to/from the
reference's parameter trees."""
