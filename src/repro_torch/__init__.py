"""C2MAB-V on PyTorch and CUDA: the port of the `repro` package.

Each module sits at the same relative path as its JAX counterpart (for
example `repro_torch/core/relax.py` ports `repro/core/relax.py`) and keeps
its public names. Code is batched first along an explicit tenant axis.
Every public entry point takes ``device=`` (default ``"cuda"``) and raises
when that device is missing; nothing runs quietly on the CPU. The two
main-path kernels, `kernels.topn_lp` and `kernels.awc_fw`, are CUDA C++ for
sm_90a; a tensor on the CPU takes their plain PyTorch versions.
"""
