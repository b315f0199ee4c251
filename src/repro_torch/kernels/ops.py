"""Device dispatch, build at first use, and launch counts for the kernels.

A tensor on the CPU goes to the kernel's plain PyTorch version; a tensor on
CUDA goes to the hand-written kernel, or raises. There is no environment
switch and no fallback: the device of the input decides. A tensor on the
``meta`` device (shapes only: the dry run, `launch.dryrun`) takes the
model kernels' plain versions too, which compute nothing there; the fleet
kernels (`topn_lp`, `awc_fw`), which no dry run reaches, raise on it.

The kernels are CUDA C++ with a plain C interface (`csrc/*.cu`), compiled
by ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` into
`build/kernels/` of the checkout the first time a CUDA tensor needs them
(or when `build` is called), and loaded with ctypes. The library's file
name carries a hash of its source, so an edited source is rebuilt.

`LAUNCHES` counts, per kernel, the launches made through `topn_lp`,
`awc_fw`, `flash_attention`, `decode_attention` (with
`decode_attention_lse`, the same kernel) and `ssd_chunk`;
`reset_launches` sets them to 0.

Gradients: a kernel writes into a tensor of its own, which autograd cannot
see through. `flash_attention` and `ssd_chunk`, which training runs, launch
through an autograd Function (`FlashAttentionFn`, `SSDChunkFn`) whose
backward recomputes the plain version and differentiates it; that
recompute launches nothing and counts nothing. `topn_lp`, `awc_fw` and
`decode_attention` have no gradient in the reference: on CUDA they raise
when grad mode is on and an input requires grad, rather than return a
result that silently drops it.

DTensors (a model whose parameters are placed on a mesh,
`sharding.distribute_tree`): `flash_attention` and `ssd_chunk` run under
`torch.distributed.tensor.experimental.local_map`, each rank calling the
kernel (on the CPU its plain version) on its own block, placed by the
reference's logical axes at those calls: q ("batch", "seq", "heads",
None), k/v ("batch", "seq", "kv_heads", None), the SSD inputs by xh's
("batch", "seq", "ssm_heads", None). Where q's heads split over a mesh dim
and the kv heads do not, each rank gets the kv heads its own q heads read
(q head i reads kv head i // n_rep). An input every rank of such a dim
reads whole (k/v there, the SSD's B/C) gets a partial gradient there
(`sharding.grad_placements`). `decode_attention` of DTensors (a cache
placed by `models.model.decode_cache_axes`) runs under `local_map` too:
q whole over the mesh dims that split the cache's slots ("cache_seq"),
each rank the kernel on its own block of T with its local pos and the
log-sum-exp output, the blocks' outputs combined by `merge_partials` over
those dims, so the cache is never gathered (the reference's flash-decode
sharding); a cache whose T is whole on every rank takes one plain call on
each rank's rows and heads. `topn_lp` and `awc_fw` raise on a DTensor:
none is gathered in silence.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

from repro_torch import sharding
from repro_torch.kernels import awc_fw as _awc
from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import topn_lp as _topn

KERNELS = {m.NAME: m for m in (_topn, _awc, _fa, _dec, _ssd)}
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
_PLAIN = ("cpu", "meta")     # devices whose tensors take the model kernels'
#                              plain versions
_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for path in candidates:
        if path.is_file():
            return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    src = KERNELS[name].SOURCE
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode()
                          ).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named kernels (all by default) that are not built yet,
    one nvcc process per source, all started together. Returns the seconds
    each build took (0.0 for a library already on disk)."""
    names = list(KERNELS) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, seconds = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(KERNELS[name].SOURCE)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        fn = getattr(lib, KERNELS[name].ENTRY)
        fn.argtypes = KERNELS[name].ARGTYPES
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def _cuda_ready(t, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} takes CPU or CUDA tensors, got {t.device}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"{name} was given a tensor on {t.device} but no "
                           "CUDA device is available")


def _no_grad(name: str, *tensors) -> None:
    """Raise if autograd would need a gradient through kernel ``name``,
    which has none."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no gradient: its kernel's output "
                           "would drop the gradient of an input that "
                           "requires grad (run it under torch.no_grad(), or "
                           "detach the inputs)")


def _no_dtensor(name: str, *tensors) -> None:
    """Raise if a DTensor reaches kernel ``name``, which has no placement
    rule."""
    if any(sharding.is_dtensor(t) for t in tensors):
        raise TypeError(f"{name} takes no DTensor: only flash_attention and "
                        "ssd_chunk run on a mesh's shards")


def topn_lp(score, cost, n, *, equality: bool = True):
    """Top-n-by-score cost reduction: score/cost (B, K), n (B,) -> (B,)."""
    _no_dtensor("topn_lp", score, cost, n)
    if score.device.type == "cpu":
        return _topn.topn_lp_plain(score, cost, n, equality=equality)
    _cuda_ready(score, "topn_lp")
    _no_grad("topn_lp", score, cost)
    out = _topn.topn_lp_cuda(library("topn_lp"), score, cost, n,
                             equality=equality)
    if out.numel():                  # an empty batch launches nothing
        LAUNCHES["topn_lp"] += 1
    return out


def awc_fw(z, mu, cost, lams, n):
    """Fused AWC FW step: z/mu/cost (B, K), lams (B, G), n (B,) ->
    (g (B, K), costs (B, G))."""
    _no_dtensor("awc_fw", z, mu, cost, lams, n)
    if z.device.type == "cpu":
        return _awc.awc_fw_plain(z, mu, cost, lams, n)
    _cuda_ready(z, "awc_fw")
    _no_grad("awc_fw", z, mu, cost, lams)
    g, costs = _awc.awc_fw_cuda(library("awc_fw"), z, mu, cost, lams, n)
    if costs.numel():                # an empty batch launches nothing
        LAUNCHES["awc_fw"] += 1
    return g, costs


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None):
    """Prefill attention: q (B,S,H,hd), k/v (B,T,KV,hd) -> (B,S,H,hd)."""
    if sharding.is_dtensor(q):
        return _flash_on_shards(q, k, v, causal=causal, window=window)
    if q.device.type in _PLAIN:
        return _fa.flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
    _cuda_ready(q, "flash_attention")
    return _fa.FlashAttentionFn.apply(_flash_launch, q, k, v, causal, window)


def _flash_launch(q, k, v, *, causal: bool, window: Optional[int]):
    out = _fa.flash_attention_cuda(library("flash_attention"), q, k, v,
                                   causal=causal, window=window)
    if out.numel():                  # an empty batch launches nothing
        LAUNCHES["flash_attention"] += 1
    return out


def decode_attention(q, k, v, pos):
    """One-token attention against a cache: q (B,1,H,hd), k/v (B,T,KV,hd),
    pos scalar or (B,) -> (B,1,H,hd)."""
    if sharding.is_dtensor(k):
        return _decode_on_shards(q, k, v, pos)
    _no_dtensor("decode_attention", q, k, v, pos)
    if q.device.type in _PLAIN:
        return _dec.decode_attention_plain(q, k, v, pos)
    _cuda_ready(q, "decode_attention")
    _no_grad("decode_attention", q, k, v)
    out = _dec.decode_attention_cuda(library("decode_attention"), q, k, v,
                                     pos)
    if out.numel():                  # an empty batch launches nothing
        LAUNCHES["decode_attention"] += 1
    return out


def decode_attention_lse(q, k, v, pos):
    """`decode_attention` and each (row, head)'s log-sum-exp of its scaled
    scores over the slots it read: -> (o (B,1,H,hd), lse (B,H) fp32, -inf
    for a row with no valid slot). One launch of the same kernel."""
    _no_dtensor("decode_attention_lse", q, k, v, pos)
    if q.device.type in _PLAIN:
        return _dec.decode_attention_lse_plain(q, k, v, pos)
    _cuda_ready(q, "decode_attention_lse")
    _no_grad("decode_attention_lse", q, k, v)
    out, lse = _dec.decode_attention_cuda(library("decode_attention"), q, k,
                                          v, pos, lse=True)
    if out.numel():                  # an empty batch launches nothing
        LAUNCHES["decode_attention"] += 1
    return out, lse


def ssd_chunk(xd, acum, bm, cm):
    """Mamba2 SSD intra-chunk dual form: xd (B,NC,L,H,P), acum (B,NC,L,H),
    bm/cm (B,NC,L,N) -> (y (B,NC,L,H,P), states (B,NC,H,P,N)), fp32."""
    if sharding.is_dtensor(xd):
        return _ssd_on_shards(xd, acum, bm, cm)
    if xd.device.type in _PLAIN:
        return _ssd.ssd_chunk_plain(xd, acum, bm, cm)
    _cuda_ready(xd, "ssd_chunk")
    return _ssd.SSDChunkFn.apply(_ssd_launch, xd, acum, bm, cm)


def _ssd_launch(xd, acum, bm, cm):
    y, states = _ssd.ssd_chunk_cuda(library("ssd_chunk"), xd, acum, bm, cm)
    if y.numel():                    # an empty batch launches nothing
        LAUNCHES["ssd_chunk"] += 1
    return y, states


# ================================================================ on a mesh
def _placed(x, logical) -> tuple:
    """The placements of ``x``'s shape by its logical axes on its mesh."""
    mesh = x.device_mesh
    return sharding.placements(sharding.spec_for(tuple(x.shape), logical,
                                                 mesh), mesh)


def kv_heads_of(block: int, h_loc: int, n_rep: int):
    """The kv heads that q heads block*h_loc .. block*h_loc + h_loc - 1
    read (q head i reads kv head i // n_rep): a slice where they form
    whole groups of one kv head or whole kv heads, else one kv head a q
    head (an index list)."""
    first = block * h_loc // n_rep
    last = (block * h_loc + h_loc - 1) // n_rep
    if h_loc % n_rep == 0 or n_rep % h_loc == 0:
        return slice(first, last + 1)
    return [(block * h_loc + i) // n_rep for i in range(h_loc)]


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous: a
    gradient leaving a `local_map` region becomes a DTensor whose later
    views DTensor plans on the global strides, which a non-contiguous local
    block does not have."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _contiguous_grads(*tensors):
    if not torch.is_grad_enabled():
        return tensors
    return tuple(_ContiguousGrad.apply(t) if t.requires_grad else t
                 for t in tensors)


def _flash_on_shards(q, k, v, *, causal: bool, window: Optional[int]):
    """`flash_attention` of DTensors: each rank's q heads against the kv
    heads they read, under `local_map`."""
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    pq = _placed(q, ("batch", "seq", "heads", None))
    pk = _placed(k, ("batch", "seq", "kv_heads", None))
    n_rep = q.shape[2] // k.shape[2]
    gqa_split = any(a.is_shard(2) and not b.is_shard(2)
                    for a, b in zip(pq, pk))
    block = sharding.block_index(mesh, pq, 2)

    def local(ql, kl, vl):
        ql, kl, vl = _contiguous_grads(ql, kl, vl)
        if gqa_split:
            heads = kv_heads_of(block, ql.shape[2], n_rep)
            kl, vl = kl[:, :, heads], vl[:, :, heads]
        return flash_attention(ql, kl, vl, causal=causal, window=window)
    gk = sharding.grad_placements(pk, pq)
    return local_map(local, out_placements=list(pq),
                     in_placements=(pq, pk, pk),
                     in_grad_placements=(pq, gk, gk), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v)


def _decode_on_shards(q, k, v, pos):
    """`decode_attention` of a DTensor cache (k/v (B,T,KV,hd) placed by
    the cache's axes; q and pos DTensors or whole tensors) under
    `local_map`. q goes whole over the mesh dims that split T (all its
    heads) and by the cache's batch and kv-head blocks elsewhere (a
    cache's kv heads split where its T cannot be: q's heads follow in whole
    groups). With T split, each rank runs `decode_attention_lse` on its
    block [r·T_l, (r+1)·T_l) at local_pos = clamp(min(pos, T-1) - r·T_l,
    -1, T_l-1), which covers the ring (the raw pos, no mask) and a frozen
    row, and `merge_partials` combines the blocks over those mesh dims."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.kernels.decode_attention import (merge_partials,
                                                      row_positions)
    mesh = k.device_mesh
    pk = tuple(k.placements)
    t_dims = [i for i, p in enumerate(pk) if p.is_shard(1)]
    if len(t_dims) > 1 or any(p.is_partial() or (p.is_shard() and p.dim > 2)
                              for p in pk):
        raise ValueError(f"decode_attention takes a cache split over its "
                         f"batch, kv heads and over one mesh dim its slots, "
                         f"got {pk}")
    pq = tuple(p if p.is_shard(0) or p.is_shard(2) else Replicate()
               for p in pk)
    prow = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in pk)
    b, t = k.shape[:2]
    if not sharding.is_dtensor(pos):
        pos = sharding.distribute(row_positions(pos, b, k.to_local().device),
                                  (None,), mesh)
    if not sharding.is_dtensor(q):
        q = sharding.distribute(q, (None,) * 4, mesh)
    if not t_dims:
        def local(ql, kl, vl, pl):
            return decode_attention(ql, kl, vl, pl)
    else:
        dim = t_dims[0]
        group = (mesh, dim)
        t_l = t // mesh.size(dim)
        r = mesh.get_local_rank(dim)

        def local(ql, kl, vl, pl):
            lp = (torch.clamp(pl, max=t - 1) - r * t_l).clamp(-1, t_l - 1)
            o, lse = decode_attention_lse(ql.contiguous(), kl, vl,
                                          lp.to(torch.int32))
            return merge_partials(o, lse, group)
    return local_map(local, out_placements=list(pq),
                     in_placements=(pq, pk, pk, prow), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v, pos)


def _ssd_on_shards(xd, acum, bm, cm):
    """`ssd_chunk` of DTensors: each rank's batch block and heads, under
    `local_map` (B/C shared by the heads, whole on every head block)."""
    from torch.distributed.tensor.experimental import local_map
    mesh = xd.device_mesh
    px = _placed(xd, ("batch", None, None, "ssm_heads", None))
    pa = _placed(acum, ("batch", None, None, "ssm_heads"))
    pb = _placed(bm, ("batch", None, None, None))
    b, nc, _, h, p = xd.shape
    ps = sharding.placements(sharding.spec_for(
        (b, nc, h, p, bm.shape[-1]), ("batch", None, "ssm_heads", None, None),
        mesh), mesh)
    gb = sharding.grad_placements(pb, px)
    return local_map(ssd_chunk, out_placements=(px, ps),
                     in_placements=(px, pa, pb, pb),
                     in_grad_placements=(px, pa, gb, gb), device_mesh=mesh,
                     redistribute_inputs=True)(xd, acum, bm, cm)
