"""The plain reference of a training cell: the model's loss and gradients,
the attack, the coordinate-wise aggregators and AdamW, in float32 with
TF32 off.  It imports only ``torch``: nothing of the port, nothing of
JAX.  The benchmark hands it the same weights and batches it hands the
port, and it works out everything else again.

The model is the configuration's own.  A configuration file names its
module with the key ``"reference"``: ``reference/<name>.py``, loaded
from its file by :func:`chipbench.bench.reference_module`; without the
key it is ``model`` (the dense and MoE decoder).  ``model`` below is the
configuration file's ``port`` group, the same dict the port's
``ModelConfig`` is built from.  A reference module has:

- ``param_specs(model)``: every weight leaf by its path in the port's
  parameter tree ("blocks/p0_attn/wq"), in the port's tree order, as
  (shape, std of its N(0, std²) draw); a leaf under ``blocks/`` is
  stacked on its first axis, one entry a layer;
- ``loss(leaves, tokens, labels, model, mm)``: one worker's scalar loss
  on its (rows, seq) int32 tokens and labels, ``leaves[path]`` a list of
  tensors (one a layer for a ``blocks/`` leaf, one for the rest), every
  matrix product the port runs in the model's dtype through ``mm(a, b)``;
- ``matmul(a, b)``: the reference's product, float32;
- ``fp8_matmul(a, b)``: the control's, the same product in float8;
- ``model_flops_per_step(model, traffic)``: the model FLOPs of one
  training step over every worker's tokens, counted from the shapes
  (``train_mfu``'s numerator).

``train`` (the steps, the attack, the aggregate, AdamW) and ``robust``
serve every model.
"""
