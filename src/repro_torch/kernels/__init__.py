"""Hand-written Hopper kernels of the port, each beside its plain version.

  topn_lp  — top-n-by-score cost reduction over (B, K) rows with a per-row
             n: the wide relaxed solve's scalar cost probe
             (CUDA C++, `csrc/topn_lp.cu`; replaces repro/kernels/topn_lp.py)
  awc_fw   — fused AWC Frank-Wolfe gradient + λ-ladder probe costs
             (CUDA C++, `csrc/awc_fw.cu`; replaces repro/kernels/awc_fw.py)

`ops` dispatches by the tensor's device: a CPU tensor takes the plain
PyTorch version, a CUDA tensor the kernel (built by nvcc at first use into
`build/kernels/` of the checkout) or an error. It also counts launches.
"""
