"""The paper's experiment models and the weight carrier to/from the
reference's parameter dicts."""
