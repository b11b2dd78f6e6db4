"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
twin (counterpart of ``repro/kernels``).

Two families:

* **substrate kernels** — ``flash_attention_cuda``, ``rmsnorm_cuda``,
  ``mlstm_cuda``: attention, norm and recurrence, with the ``ops`` entry
  points and the ``ref`` oracles;
* **mixing kernels** — ``mixing_cuda``: gossip mixing and periodic
  averaging fused into single-pass kernels, selected by
  ``comm_backend="pallas"``.

Sources live in ``repro_torch/csrc``; ``cuda_build`` compiles them on
first use.  Importing this package builds nothing.
"""
from repro_torch.kernels.mixing_cuda import (fused_step_mix,  # noqa: F401
                                             global_average, mix_residual,
                                             pod_average)
from repro_torch.kernels.ops import (flash_attention_op,  # noqa: F401
                                     mlstm_chunk_op, rmsnorm_op)
from repro_torch.kernels.ref import (flash_attention_ref,  # noqa: F401
                                     mlstm_chunk_ref, rmsnorm_ref)
