"""Flash attention (forward) — kernel K1 and its plain versions.

`flash_attention` launches csrc/flash_attention.cu for CUDA tensors and
uses `xla_attention`, the plain einsum form, for CPU tensors. Layout is
the JAX package's (B, H, S, D); output is in q.dtype.

It takes the TPU kernel's whole contract: any head dim D <= 256, and the
block arguments `block_q` / `block_k`. The kernel is instantiated at D in
`HEAD_DIMS` (32, 64, 128, 256); any other D is zero-padded along D to the
next one and the output sliced back. That is exact: zero columns add
nothing to q·kᵀ, and v's zero columns add only output columns that are cut
off. On the card the blocks name K1's own tiles (`TILES`): block_q = 128
runs two warpgroups on one K/V ring, block_k = 128 a 128-row kv tile; 0
keeps (64, 64), the main path's tile. A block the card's shared memory or
registers cannot hold at that D, such as the TPU's 384 or 1152, raises a
ValueError naming the tiles it takes, on every device, and is never
replaced by another tile. The fp32 body has its own tile, so an fp32 call
with a nonzero block raises. The plain version ignores the tiles, which
change only the order of the sums.

On the card q, k and v may be strided views (a contiguous D axis, any
strides for B, H and S, e.g. the slices of a (B, S, 3, H, D) qkv product),
and the output is a (B, H, S, D) view of a (B, S, H, D) buffer, so
`out.transpose(1, 2)` is contiguous (at a padded D, a view of its first D
columns). bf16 runs on the tensor cores (wgmma, TMA loads), fp32 on the
SIMT pipes.

`xla_attention_bf16` is the JAX package's bf16-score form, a plain
function with its rounding steps (attention_impl "xla_bf16").

The kernel is also the custom operator `wvn::flash_attention`
(torch.library.custom_op), so `torch.export` records it as one node of the
graph, and the engine AOTInductor compiles from that graph
(feature_extractor/aot_engine.py) calls it through Inductor's proxy
executor: K1 stays the attention there, and its launches count. Its fake (shape-only) version gives the layout the real
call returns on each device: on CUDA the (B, H, S, D) view of a
(B, S, H, D) buffer, on the CPU a contiguous tensor. `flash_attention` is
the one entry point: under torch.export it calls the operator; eager calls
run the operator's body directly, because the dispatcher's cost (23 to 37
µs per call on the card's host, 0.27 to 0.45 ms over a frame's 12 calls,
and 0.4 to 4.9 ms of frame time in paired runs; NVIDIA H100 80GB HBM3,
chip_smoke.py phase 4k) is more than the 0.3 ms per frame the port allows
it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _cuda

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256  # the TPU kernel's bound (its docstring)
HEAD_DIMS = (32, 64, 128, 256)  # the head dims K1 is instantiated at
# (block_q, block_k) tiles of K1's bf16 body at each instantiated D: the
# same table as csrc/flash_attention.cuh::has_tile. D = 256 with 128-row kv
# tiles would need 288 KB of shared memory.
_ALL_TILES = ((64, 64), (128, 64), (64, 128), (128, 128))
TILES = {32: _ALL_TILES, 64: _ALL_TILES, 128: _ALL_TILES, 256: ((64, 64), (128, 64))}


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float = 1.0) -> torch.Tensor:
    """softmax(q kᵀ · sm_scale) v with fp32 scores and fp32 accumulation,
    p rounded to v.dtype before the second product (the reference's
    `xla_attention`). Output in q.dtype."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def xla_attention_bf16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float = 1.0) -> torch.Tensor:
    """The reference's `xla_attention_bf16`, with its rounding steps: the
    scores q·kᵀ accumulated in fp32 and stored in bf16, scaled in fp32; the
    max and the exponentials in fp32, the probabilities rounded to bf16 and
    summed in fp32; p·v in bf16 operands with fp32 accumulation, divided by
    the sum in fp32. Output in q.dtype."""
    bf = torch.bfloat16
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()).to(bf)
    s = s.float() * sm_scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).to(bf)
    l = p.float().sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p.float(), v.to(bf).float())
    return (out / l).to(q.dtype)


def bf16_atol(ref: torch.Tensor) -> float:
    """The absolute error that K1's bf16 output is held to against
    `xla_attention` on the same inputs: 2**-6 of the output's largest
    |value|, 2 to 4 bf16 units in the last place of the largest outputs.
    Both sides round p and the output to bf16, so they may differ there by
    one or two units. Leaving out the last kv tile moves some output by 7
    to 40 times this at the ViT shapes (tests/test_torch_port_attention_vit.py)."""
    return float(ref.float().abs().max()) * 2.0**-6


def padded_head_dim(D: int) -> int:
    """The instantiated head dim a call at D runs at (D itself or the next
    one up, with zero columns); raises above MAX_HEAD_DIM."""
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim must be in [1, {MAX_HEAD_DIM}] (the TPU kernel's bound), got {D}")
    return next(d for d in HEAD_DIMS if d >= D)


def kernel_tile(D: int, dtype: torch.dtype, block_q: int = 0, block_k: int = 0) -> tuple[int, int] | None:
    """The bf16 tile (block_q, block_k) that a call at head dim D runs, 0
    meaning 64; None for an fp32 call, whose body has its own tile. Raises
    a ValueError naming the tiles D takes for any other block, on every
    device: a block is never replaced by another tile."""
    Dp = padded_head_dim(D)
    if dtype == torch.float32:
        if block_q or block_k:
            raise ValueError(f"flash_attention: the fp32 kernel has its own tile; block_q and block_k must be 0, "
                             f"got ({block_q}, {block_k})")
        return None
    tile = (block_q or 64, block_k or 64)
    if tile not in TILES[Dp]:
        raise ValueError(f"flash_attention: tile (block_q, block_k) = {tile} is not one the card holds at head dim "
                         f"{D} (run at {Dp}); it takes {list(TILES[Dp])}, and 0 for (64, 64)")
    return tile


@functools.lru_cache(maxsize=None)
def _plan(D: int, dtype: torch.dtype, block_q: int, block_k: int) -> tuple[int, tuple[int, int] | None, str]:
    """(the instantiated head dim, the tile, the count's key) of a call,
    validated once per distinct (D, dtype, block_q, block_k): the frame's
    12 calls repeat one signature."""
    tile = kernel_tile(D, dtype, block_q, block_k)
    Dp = padded_head_dim(D)
    name = f"fp32 d{Dp}" if tile is None else f"bf16 d{Dp} {tile[0]}x{tile[1]}"
    return Dp, tile, name if Dp == D else f"{name} (D={D})"


def variant_name(D: int, dtype: torch.dtype, block_q: int = 0, block_k: int = 0) -> str:
    """The key a call counts under in `flash_attention.variant_launches`:
    the instantiation it runs, e.g. "bf16 d64 64x64", "fp32 d128", and a
    zero-padded head dim's own, e.g. "bf16 d128 64x64 (D=80)"."""
    return _plan(D, dtype, block_q, block_k)[2]


def _outer_strides(name: str, t: torch.Tensor) -> list[int]:
    """The (B, H, S) strides of t in elements, checked for the kernel: a
    contiguous last axis and, as TMA needs, 16-byte aligned base and
    strides. An axis of size 1 is never stepped, so it gets the tensor's
    extent as a harmless stride."""
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: the head axis must be contiguous, got strides {t.stride()}")
    per16 = 16 // t.element_size()
    extent = max(s * n for s, n in zip(t.stride(), t.shape))
    extent = -(-max(extent, 1) // per16) * per16
    strides = [s if n > 1 else extent for s, n in zip(t.stride()[:3], t.shape[:3])]
    if t.data_ptr() % 16 or any(s % per16 for s in strides):
        raise ValueError(f"{name}: base and (B, H, S) strides must be 16-byte aligned, got strides {t.stride()}")
    return strides


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block_q: int,
           block_k: int) -> tuple[int, tuple[int, int] | None, str]:
    """What every call must satisfy, on every device: one (B, H, S, D)
    shape, D <= 256, and a tile the card holds at D for the dtype. Returns
    the call's `_plan`."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"flash_attention: q, k, v must share one (B, H, S, D) shape, got {q.shape}, {k.shape}, {v.shape}")
    return _plan(q.shape[-1], q.dtype if q.dtype in _DTYPES else torch.bfloat16, block_q, block_k)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float, Dp: int,
            tile: tuple[int, int] | None, name: str) -> torch.Tensor:
    """K1 on CUDA tensors (bf16 or fp32) at the instantiated head dim Dp and
    tile of the call's `_plan`, or raise. A head dim between the
    instantiated ones runs Dp on zero-padded copies, and returns the view
    of its first D output columns."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtype must be float32 or bfloat16 for all of q, k, v, got {q.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q, k, v on different devices: {q.device}, {k.device}, {v.device}")
    B, H, S, D = q.shape
    if Dp != D:
        q, k, v = (torch.nn.functional.pad(t, (0, Dp - D)) for t in (q, k, v))
    out = torch.empty((B, S, H, Dp), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in _outer_strides("flash_attention", t)))
    bq, bk = tile or (0, 0)
    lib = _cuda.library()
    with torch.cuda.device(q.device):
        err = lib.wvn_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ctypes.addressof(strides),
            B, H, S, Dp, _DTYPES[q.dtype], float(sm_scale), bq, bk, _cuda.stream_of(q),
        )
    _cuda.check(err, "flash_attention")
    _cuda.count_launch(flash_attention, name)
    return out if Dp == D else out[..., :D]


def _flash_attention_body(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float, block_q: int = 0,
                          block_k: int = 0) -> torch.Tensor:
    """The operator's body: K1 for CUDA tensors, the plain version
    (contiguous) for CPU tensors."""
    Dp, tile, name = _check(q, k, v, block_q, block_k)
    if q.device.type == "cpu":
        return xla_attention(q, k, v, sm_scale).contiguous()
    return _launch(q, k, v, sm_scale, Dp, tile, name)


flash_attention_op = torch.library.custom_op("wvn::flash_attention", _flash_attention_body, mutates_args=())


@flash_attention_op.register_fake
def _flash_attention_fake(q, k, v, sm_scale, block_q=0, block_k=0):
    B, H, S, D = q.shape
    if q.device.type == "cuda":
        Dp = padded_head_dim(D)
        return q.new_empty((B, S, H, Dp)).transpose(1, 2)[..., :D]
    return q.new_empty((B, H, S, D))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float = 1.0, block_q: int = 0,
                    block_k: int = 0) -> torch.Tensor:
    """softmax(q kᵀ · sm_scale) v. q, k, v: (B, H, S, D), D <= 256;
    `block_q` / `block_k` name K1's tile (0: (64, 64); `TILES`). Under
    torch.export the operator `wvn::flash_attention`.

    CUDA tensors run kernel K1 (bf16 or fp32) or raise; CPU tensors take
    the plain version. Every device raises for D > 256 and for a tile K1
    does not hold."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if torch.compiler.is_exporting():
        return flash_attention_op(q, k, v, float(sm_scale), int(block_q), int(block_k))
    return _flash_attention_body(q, k, v, float(sm_scale), int(block_q), int(block_k))


flash_attention.launches = 0
flash_attention.variant_launches = {}  # launches by `variant_name`, reset with `launches`
