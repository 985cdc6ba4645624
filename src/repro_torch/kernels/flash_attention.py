"""Flash attention on Hopper — the counterpart of
``repro.kernels.flash_attention`` (TPU kernel ``_flash_kernel``) — and
its gradient.

``flash_attention_cuda`` launches ``csrc/flash_attention.cu`` on CUDA
tensors; the custom op ``repro_torch::flash_attention`` runs the plain
version on CPU tensors and gives the counter its fake impl.

The gradient: on the card :class:`FlashAttention` (an
``autograd.Function``) runs the forward kernel with each row's
log-sum-exp kept (``flash_attention_lse_cuda``) and its backward
launches ``csrc/flash_attention_bwd.cu`` (``flash_attention_bwd_cuda``:
Δ = rowsum(P∘dP), then dQ, then dK and dV, no atomics; in bf16 three
passes of warpgroup ``wgmma`` products on TMA-loaded tiles where the
operands allow it (:func:`route`), else four ``mma.sync``
passes; in f32 four FMA passes).  On
the host the custom op's autograd calls the custom op
``repro_torch::flash_attention_bwd``, whose CPU impl is the plain vjp
(``ref.attention_bwd_ref``) and whose fake impl lets the counter price
a training step.  The reference has no backward kernel: it
differentiates its jnp attention.  One CUDA
block owns a query tile of a (batch, head) and streams the keys in
``TILE_K``-row tiles with the softmax state in registers, visiting only
the kv tiles its rows can see (:func:`kv_tile_range`), by one of three
routes the kernel picks from the operands (:func:`route`, the rule the
backward follows too; :func:`routes` counts them): bf16 that TMA tensor
maps can describe on warpgroup ``wgmma`` products fed by a TMA ring (one
producer warpgroup, two consumer warpgroups of 64 query rows), other
bf16 on ``mma.sync``, both with 128-row query tiles; f32 as FMA with
64-row ones (``FWD_TILES``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, _observe
from repro_torch.kernels.ref import attention_bwd_ref, attention_ref

#: launches of the forward CUDA kernel in this process (with or without
#: the log-sum-exp)
launches = 0
#: calls of ``flash_attention_bwd_cuda`` (each launches the backward's
#: four kernels) in this process
backward_launches = 0

#: key rows per inner step of every forward route (kTileK in the source)
TILE_K = 64
#: the forward's routes (csrc/flash_attention.cu, :func:`route`): query
#: rows a CUDA block owns and key rows a tile — the bf16 wgmma path
#: (``wg_path``: two consumers of 64 rows), its mma.sync route
#: (``mma_path``) and the f32 FMA path (``fma_path``)
FWD_TILES = {"wgmma": (128, TILE_K), "mma_sync": (128, TILE_K),
             "fma": (64, TILE_K)}
#: largest head dimension (D and Dv) the kernel takes
MAX_HEAD_DIM = 256
#: the backward's routes (csrc/flash_attention_bwd.cu): rows a CUDA block
#: owns (queries in its Δ and dQ passes, keys in its dK and dV passes),
#: column rows per step, and whether dK and dV are one pass — the bf16
#: wgmma path (``wg_path``), its mma.sync fallback (``mma_path``) and the
#: f32 FMA path (``fma_path``)
BWD_TILES = {"wgmma": (64, 64, True), "mma_sync": (64, 32, False),
             "fma": (32, 32, False)}

_ENTRY = {torch.float32: "repro_flash_attention_f32",
          torch.bfloat16: "repro_flash_attention_bf16"}
_BWD_ENTRY = {torch.float32: "repro_flash_attention_bwd_f32",
              torch.bfloat16: "repro_flash_attention_bwd_bf16"}


def kv_tile_range(q_first: int, q_last: int, skv: int, causal: bool,
                  window: Optional[int], tile: int = TILE_K
                  ) -> Tuple[int, int]:
    """The kv tiles ``[lo, hi)`` query rows ``[q_first, q_last]`` can see,
    as the kernel computes them: keys ``[max(0, q_first − window + 1),
    min(Skv, q_last + 1))`` — the lower end only with a window, the upper
    end only when causal (none under a causal mask with window 0) —
    rounded out to whole ``tile``-row tiles."""
    lo = max(0, q_first - window + 1) if window is not None else 0
    hi = skv if not causal else 0 if window == 0 else min(skv, q_last + 1)
    t_lo = lo // tile
    return (t_lo, -(-hi // tile)) if lo < hi else (t_lo, t_lo)


def q_tile_range(k_first: int, k_last: int, sq: int, causal: bool,
                 window: Optional[int], tile: int) -> Tuple[int, int]:
    """The query tiles ``[lo, hi)`` that see a key of rows ``[k_first,
    k_last]``, as the backward's dK and dV passes walk them: queries
    ``[k_first if causal else 0, min(Sq, k_last + window))`` (none under
    a causal mask with window 0), rounded out to whole tiles."""
    lo = k_first if causal else 0
    hi = min(sq, k_last + window) if window is not None else sq
    if causal and window == 0:
        hi = lo
    t_lo = lo // tile
    return (t_lo, -(-hi // tile)) if lo < hi else (t_lo, t_lo)


def route(dtype: torch.dtype, d: int, dv: int, aligned: bool = True) -> str:
    """The route of either direction for operands of ``dtype`` and head
    dims ``d``, ``dv``: bf16 takes the wgmma path where TMA tensor maps
    can describe the operands (D and Dv multiples of 8, and every operand
    — q, k, v, and dout in the backward — 16-byte aligned: ``aligned``),
    else mma.sync; f32 the FMA path.  The kernels decide the same from
    the operands' addresses (``tma_takes_bf16`` in
    ``csrc/wgmma_sm90.cuh``; the forward also needs a key).  The cost
    rules have shapes only and price operands as PyTorch allocates them,
    aligned: a view that starts off a 16-byte boundary runs the mma.sync
    route but is priced as the wgmma route's staging."""
    if dtype == torch.float32:
        return "fma"
    ok = aligned and d % 8 == 0 and dv % 8 == 0
    return "wgmma" if ok else "mma_sync"


def _route_counts(entry: str, names: Tuple[str, ...]) -> dict:
    import ctypes
    out = (ctypes.c_longlong * len(names))()
    getattr(_build.library(), entry)(out)
    return dict(zip(names, out))


def routes() -> dict:
    """Calls of the forward kernel by route since the library loaded
    (counted in the kernel's own dispatch; :func:`flash_attention_mma_cuda`
    counts as ``mma_sync``)."""
    return _route_counts("repro_flash_attention_routes",
                         ("wgmma", "mma_sync", "fma"))


def bwd_routes() -> dict:
    """Calls of the bf16 backward kernel by route since the library
    loaded (counted in the kernel's own dispatch)."""
    return _route_counts("repro_flash_attention_bwd_routes",
                         ("wgmma", "mma_sync"))


def bwd_steps(sq: int, skv: int, causal: bool, window: Optional[int],
              route: str) -> Tuple[int, int]:
    """Column steps of the backward for one (batch, query head) on
    ``route``: of its dQ pass (key tiles its query tiles see, the same as
    its Δ pass) and of its dK pass (query tiles of this head that see
    each key tile, the same as its dV pass, or the fused dK+dV pass)."""
    rows, cols, _ = BWD_TILES[route]
    dq = sum(hi - lo for lo, hi in (
        kv_tile_range(r, min(r + rows, sq) - 1, skv, causal, window, cols)
        for r in range(0, sq, rows)))
    dkv = sum(hi - lo for lo, hi in (
        q_tile_range(r, min(r + rows, skv) - 1, sq, causal, window, cols)
        for r in range(0, skv, rows)))
    return dq, dkv


def kv_tiles_visited(sq: int, skv: int, causal: bool, window: Optional[int],
                     tile_q: int) -> int:
    """kv tiles the kernel stages for one (batch, head), summed over its
    ``tile_q``-row query tiles (a full sweep stages ``ceil(Sq / tile_q) ·
    ceil(Skv / TILE_K)``)."""
    total = 0
    for q0 in range(0, sq, tile_q):
        lo, hi = kv_tile_range(q0, min(q0 + tile_q, sq) - 1, skv, causal,
                               window)
        total += hi - lo
    return total


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cpu")
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, window: Optional[int],
                    softcap: Optional[float], scale: float, block_q: int,
                    block_k: int) -> torch.Tensor:
    """q[B, Sq, Hq, D], k/v[B, Skv, Hkv, D*] → [B, Sq, Hq, Dv]."""
    return attention_ref(q, k, v, causal=causal, window=window,
                         softcap=softcap, scale=scale)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int], softcap: Optional[float],
           *more: torch.Tensor) -> None:
    """Raise on operands the kernels do not take (``more``: further
    tensors of the backward, which must match q's dtype and device and be
    contiguous)."""
    b, sq, hq, d = q.shape
    b2, skv, hkv, d2 = k.shape
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 "
                        f"operands of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    dv = v.shape[3]
    if b2 != b or d2 != d or v.shape[:3] != k.shape[:3] or hq % hkv:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if d > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes head dims up to "
                         f"{MAX_HEAD_DIM}, got D={d}, Dv={dv}")
    if window is not None and window < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got "
                         f"{window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention: softcap must be > 0, got "
                         f"{softcap}")
    if any(t.dtype != q.dtype for t in more):
        raise TypeError(f"flash_attention backward: operands of dtype "
                        f"{[t.dtype for t in more]}, not {q.dtype}")
    if not all(t.is_contiguous() for t in (q, k, v, *more)):
        raise ValueError("flash_attention takes contiguous operands")
    if any(t.device != q.device for t in (k, v, *more)):
        raise ValueError("flash_attention operands must share one device")


def _launch(entry, q, k, v, causal, window, softcap, scale, lse: bool):
    """Allocate the output (and lse) and launch the forward's C entry
    ``entry`` on operands :func:`_check` has passed."""
    b, sq, hq, _ = q.shape
    out = torch.empty((b, sq, hq, v.shape[3]), dtype=q.dtype,
                      device=q.device)
    lse_t = torch.empty((b, hq, sq), dtype=torch.float32,
                        device=q.device) if lse else None
    _build.launch_on(q.device, entry, q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), out.data_ptr(),
                     0 if lse_t is None else lse_t.data_ptr(), b, sq,
                     k.shape[1], hq, k.shape[2], q.shape[3], v.shape[3],
                     scale, 0.0 if softcap is None else softcap,
                     int(causal), -1 if window is None else window)
    return out, lse_t


def _forward(q, k, v, causal, window, softcap, scale, lse: bool):
    global launches
    _check(q, k, v, window, softcap)
    out, lse_t = _launch(_ENTRY[q.dtype], q, k, v, causal, window, softcap,
                         scale, lse)
    launches += 1
    _observe.launched("flash_attention", (q, k, v), (out, lse_t))
    return out, lse_t


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, window: Optional[int],
                         softcap: Optional[float], scale: float,
                         block_q: int, block_k: int) -> torch.Tensor:
    """Check the operands, launch ``csrc/flash_attention.cu``, count the
    launch."""
    return _forward(q, k, v, causal, window, softcap, scale, False)[0]


def flash_attention_lse_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool,
                             window: Optional[int], softcap: Optional[float],
                             scale: float
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_cuda` that also keeps each query row's
    log-sum-exp of its scores, lse [B, Hq, Sq] float32 (natural log), for
    the backward."""
    return _forward(q, k, v, causal, window, softcap, scale, True)


def flash_attention_mma_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool,
                             window: Optional[int], softcap: Optional[float],
                             scale: float) -> torch.Tensor:
    """The bf16 forward on its mma.sync route whatever the operands
    (``repro_flash_attention_bf16_mma``), for timing and checking that
    route beside the wgmma one at the same shapes; the model path never
    calls it, and it counts in :func:`routes` only, not in
    ``launches``."""
    _check(q, k, v, window, softcap)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention_mma_cuda takes bfloat16, got "
                        f"{q.dtype}")
    return _launch("repro_flash_attention_bf16_mma", q, k, v, causal,
                   window, softcap, scale, False)[0]


def flash_attention_bwd_cuda(dout: torch.Tensor, q: torch.Tensor,
                             k: torch.Tensor, v: torch.Tensor,
                             lse: torch.Tensor, causal: bool,
                             window: Optional[int], softcap: Optional[float],
                             scale: float) -> Tuple[torch.Tensor, ...]:
    """Check the operands, launch ``csrc/flash_attention_bwd.cu`` (its Δ,
    dQ and dK/dV passes), count the call.  ``lse`` is the forward's
    (:func:`flash_attention_lse_cuda`).  Returns (dq, dk, dv) in the
    operands' dtype."""
    global backward_launches
    _check(q, k, v, window, softcap, dout)
    b, sq, hq, _ = q.shape
    if dout.shape != (b, sq, hq, v.shape[3]):
        raise ValueError(f"flash_attention backward: dout {tuple(dout.shape)}"
                         f" for q {tuple(q.shape)}, v {tuple(v.shape)}")
    if lse.shape != (b, hq, sq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"flash_attention backward: lse must be a "
                         f"contiguous float32 [{b}, {hq}, {sq}] on "
                         f"{q.device}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    _build.launch_on(q.device, _BWD_ENTRY[q.dtype], q.data_ptr(),
                     k.data_ptr(), v.data_ptr(),
                     dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                     dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq,
                     k.shape[1], hq, k.shape[2], q.shape[3], v.shape[3],
                     scale, 0.0 if softcap is None else softcap,
                     int(causal), -1 if window is None else window)
    backward_launches += 1
    _observe.launched("flash_attention_bwd", (dout, q, k, v, lse),
                      (dq, dk, dv))
    return dq, dk, dv


def wgmma_tile_product(a: torch.Tensor, b: torch.Tensor,
                       mn_major: bool) -> torch.Tensor:
    """The backward's ``wgmma`` descriptor and swizzle check: ``a`` [64,
    256] times ``b`` — ``b`` [64, 256] transposed, read K-major with ``a``
    from shared memory (the score products' form), or ``b`` [256, N], N a
    multiple of 64 up to 256, read MN-major with ``a`` from registers (the
    sums' form) — as an f32 [64, N] from one warpgroup on the card; the
    plain product in f32 on the host."""
    want = (64, 256)
    if a.shape != want or a.dtype != torch.bfloat16 or b.dtype != a.dtype \
            or (b.shape != want if not mn_major else
                b.shape[0] != 256 or b.shape[1] not in (64, 128, 192, 256)):
        raise ValueError(f"wgmma_tile_product: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)} ({a.dtype}, {b.dtype})")
    if a.device.type == "cpu":
        return a.float() @ (b.float() if mn_major else b.float().T)
    a, b = a.contiguous(), b.contiguous()
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("wgmma_tile_product: TMA takes 16-byte aligned "
                         "operands")
    n = b.shape[1] if mn_major else b.shape[0]
    c = torch.empty((64, n), dtype=torch.float32, device=a.device)
    _build.launch_on(a.device, "repro_wgmma_tile_bf16", a.data_ptr(),
                     b.data_ptr(), c.data_ptr(), n, int(mn_major))
    return c


def wgmma_pv_tile(q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """The forward's P·V check: ``bf16(q · kᵀ) · v`` for ``q``, ``k`` [64,
    256] and ``v`` [64, N], N a multiple of 64 up to 256, as an f32 [64,
    N] from one warpgroup on the card — the score product from
    TMA-loaded swizzled tiles, its accumulator rounded and packed as the
    register A operand, the sum product with ``v`` read MN-major, the
    chain the wgmma route runs each kv tile; the plain product on the
    host."""
    if q.shape != (64, 256) or k.shape != (64, 256) or v.shape[0] != 64 \
            or v.shape[1] not in (64, 128, 192, 256) \
            or any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError(f"wgmma_pv_tile: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} "
                         f"({q.dtype}, {k.dtype}, {v.dtype})")
    if q.device.type == "cpu":
        p = (q.float() @ k.float().T).to(torch.bfloat16)
        return p.float() @ v.float()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("wgmma_pv_tile: TMA takes 16-byte aligned "
                         "operands")
    c = torch.empty((64, v.shape[1]), dtype=torch.float32, device=q.device)
    _build.launch_on(q.device, "repro_wgmma_pv_tile_bf16", q.data_ptr(),
                     k.data_ptr(), v.data_ptr(), c.data_ptr(), v.shape[1])
    return c


class FlashAttention(torch.autograd.Function):
    """The card's differentiable attention: the forward kernel (keeping
    the log-sum-exp), and the backward kernel as its backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale, block_q,
                block_k):
        out, lse = flash_attention_lse_cuda(q, k, v, causal, window,
                                            softcap, scale)
        ctx.save_for_backward(q, k, v, lse)
        ctx.options = (causal, window, softcap, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse = ctx.saved_tensors
        grads = flash_attention_bwd_cuda(dout.contiguous(), q, k, v, lse,
                                         *ctx.options)
        return (*grads,) + (None,) * 6


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=(),
                         device_types="cpu")
def flash_attention_bwd(dout: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, causal: bool, window: Optional[int],
                        softcap: Optional[float], scale: float, block_q: int,
                        block_k: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``repro_torch::flash_attention``: (dq, dk, dv) for
    the output gradient ``dout``, by the plain vjp."""
    return attention_bwd_ref(dout, q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale)


@flash_attention_bwd.register_fake
def _flash_attention_bwd_fake(dout, q, k, v, causal, window, softcap, scale,
                              block_q, block_k):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _setup_context(ctx, inputs, output):
    q, k, v, *options = inputs
    ctx.save_for_backward(q, k, v)
    ctx.options = options


def _backward(ctx, dout):
    q, k, v = ctx.saved_tensors
    grads = flash_attention_bwd(dout.contiguous(), q, k, v, *ctx.options)
    return (*grads,) + (None,) * 6


@flash_attention.register_fake
def _flash_attention_fake(q, k, v, causal, window, softcap, scale, block_q,
                          block_k):
    return q.new_empty((*q.shape[:3], v.shape[3]))


flash_attention.register_autograd(_backward, setup_context=_setup_context)
