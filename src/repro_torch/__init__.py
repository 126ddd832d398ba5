"""PyTorch/CUDA port of the Byzantine-robust distributed learning system.

Mirrors the module paths of the JAX package ``repro`` (the reference it
is held against) and imports nothing of it.  Entry points that create
tensors take ``device=`` (default ``"cuda"``) and raise when CUDA is
missing rather than carrying on on the CPU; functions that receive
tensors compute on the tensors' device.

Ported so far, on one device: Algorithm 1 (robust distributed GD) —
kernels (selection network, the hand-written CUDA order-statistic and
sketch kernels), core (aggregators, attacks shim, robust_gd, theory),
attacks, data, models, checkpoint and the round engine; synchronous
federated rounds (``fed``); the round programs (``rounds``: Algorithm
2, local-update rounds, payload compression, communication accounting);
buffered async rounds and the robustness matrix; and robust serving
(``serve``: the continuous-batching engine over the dense transformer of
``models.transformer``, with robust continual adaptation from feedback).
"""
import torch

# The reference computes in full float32.  cuDNN convolutions default to
# TF32 on the card, which keeps ~3 decimal digits; the port turns both
# TF32 paths off so its gradients stay comparable with the reference.
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
