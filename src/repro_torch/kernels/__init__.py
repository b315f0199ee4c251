"""Hand-written Hopper kernels of the port, each beside its plain version.

  topn_lp  — top-n-by-score cost reduction over (B, K) rows with a per-row
             n: the wide relaxed solve's scalar cost probe
             (CUDA C++, `csrc/topn_lp.cu`; replaces repro/kernels/topn_lp.py)
  awc_fw   — fused AWC Frank-Wolfe gradient + λ-ladder probe costs
             (CUDA C++, `csrc/awc_fw.cu`; replaces repro/kernels/awc_fw.py)
  flash_attention  — tiled GQA prefill attention, fp32 online softmax
             (CUDA C++, `csrc/flash_attention.cu`; replaces
             repro/kernels/flash_attention.py)
  decode_attention — one query token against a KV cache, per-row pos
             (CUDA C++, `csrc/decode_attention.cu`; replaces
             repro/kernels/decode_attention.py)
  ssd_chunk — Mamba2 SSD intra-chunk dual form: y_intra and chunk states
             (CUDA C++, `csrc/ssd_scan.cu`; replaces
             repro/kernels/ssd_scan.py)

`ops` dispatches by the tensor's device: a CPU tensor takes the plain
PyTorch version, a CUDA tensor the kernel (built by nvcc at first use into
`build/kernels/` of the checkout) or an error. It also counts launches.
"""
