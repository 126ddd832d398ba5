"""PyTorch/CUDA port of the Byzantine-robust distributed learning system.

Mirrors the module paths of the JAX package ``repro`` (the reference it
is held against) and imports nothing of it.  Entry points that create
tensors take ``device=`` (default ``"cuda"``) and raise when CUDA is
missing rather than carrying on on the CPU; functions that receive
tensors compute on the tensors' device.

Ported: every module and public name of the reference (the JAX-only
ones aside: the Pallas entry points, shard_map and sharding-spec helpers,
HLO parsing, typed PRNG keys; tests/test_torch_api_parity.py lists them).
Algorithm 1 (robust distributed GD) — kernels (selection network, the
hand-written CUDA order-statistic and sketch kernels), core (aggregators,
attacks shim, robust_gd, theory, the robust collectives), attacks, data,
models, checkpoint (bf16 and float8 as raw bits) and the round engine;
synchronous federated rounds (``fed``); the round programs (``rounds``:
Algorithm 2, local-update rounds, payload compression, communication
accounting); buffered async rounds and the robustness matrix; robust
serving (``serve``: the continuous-batching engine over the decoder
families of ``models.transformer`` (dense, MoE, SSM, hybrid RG-LRU, the
audio and vision frontends), with robust continual adaptation from
feedback); robust LM training (``launch``) over in-process workers or a
``torch.distributed`` process group, with FSDP, a model axis and sequence
parallelism; the dry-run with its cost analysis and roofline.  The
reference's examples are ``examples/torch_*.py``.
"""
import torch

# The reference computes in full float32.  cuDNN convolutions default to
# TF32 on the card, which keeps ~3 decimal digits; the port turns both
# TF32 paths off so its gradients stay comparable with the reference.
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
