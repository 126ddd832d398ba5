"""The plain reference of a training cell: the model's loss and gradients,
the attack, the coordinate-wise aggregators and AdamW, in float32 with
TF32 off.  It imports only ``torch``: nothing of the port, nothing of
JAX.  The benchmark hands it the same weights and batches it hands the
port, and it works out everything else again.
"""
