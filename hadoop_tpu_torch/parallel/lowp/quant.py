"""Quantized collective payloads for the relaxed parity tier.

The counterpart of ``hadoop_tpu/parallel/lowp/quant.py``. Under
``parallel.parity=relaxed`` the collectives here carry, instead of the
float payload:

- ``int8``: symmetric quantization against SHARED scales: every rank
  takes the same scale through a small ``pmax`` (one f32 per scale
  group), so the integer payloads add on the wire. The quantization
  range leaves headroom for the sum: with N summing ranks each rank
  takes ``127 // N``, so the int8 sum cannot wrap; past 127 ranks the
  wire widens to int16 (``32767 // N``), and past 32767 it raises.
- ``fp8`` (``torch.float8_e4m3fn``, values scaled to at most ±240, the
  reference's headroom under the format's 448): the sum gathers the fp8
  payloads and adds them in float32 (exact: four e4m3 values sum
  exactly in float32), on one axis only; a sum over several axes, a
  reduce-scatter, takes the int8 wire, as the reference's does.

Every quantized collective is a ``torch.autograd.Function`` whose
backward is the exact collective's transpose (the reference's
straight-through ``custom_vjp``): the rounding has no useful gradient,
and a quantized tp reduce sits inside the autograd region.

Each records its wire bytes and the bytes the float form would have
moved: into every ledger that :func:`capture_comm` holds open, and into
the runtime comm ledger (``obs/comm.py``). A record made inside an
autograd backward (a remat recompute's) is dropped, as the runtime
ledger drops it. The reference records once a trace; the port records
each call, so a capture over N steps holds N steps' bytes (its ratio is
the same).

The rules are the reference's, so the bits are too: values divided by
their scale (tensor by tensor: CUDA torch turns a division by a Python
scalar into a multiplication by its reciprocal, which rounds otherwise),
rounded half to even, clipped. The scale is ``max(amax, 1e-30) / qmax``
in f32 on the host codec (the reference's numpy), and ``max(amax,
1e-30) * f32(1 / qmax)`` in the collectives: XLA compiles the
reference's division by the constant ``qmax`` into that product. The
MoE payload's round trip on one device (the serving engine's) keeps the
host's rule.
Wire dtypes gloo lacks (int16, fp8) travel as bytes (``spmd``).

Host-side codec: :func:`quantize_array` / :func:`dequantize_array` (the
one per-group codec, also the serving weight plane's) and
:func:`encode_payload` / :func:`decode_payload`, the self-describing
wire form, whose header and bytes are the reference's.
"""

from __future__ import annotations

import dataclasses
import json
import struct
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hadoop_tpu_torch.obs.comm import record_comm, static_nbytes
from hadoop_tpu_torch.parallel import spmd
from hadoop_tpu_torch.parallel.lowp import WIRE_CODECS

_TINY = 1e-30          # scale floor: an all-zeros group stays exactly 0
_F8_MAX = 240.0        # e4m3 headroom below the 448 format max
_F8 = torch.float8_e4m3fn


@dataclasses.dataclass(frozen=True)
class RelaxedQuant:
    """How a relaxed-tier collective quantizes its payload."""
    codec: str = "int8"
    group: int = 1024                     # elements per shared scale

    def __post_init__(self):
        if self.codec not in WIRE_CODECS:
            raise ValueError(f"relaxed wire codec must be one of "
                             f"{WIRE_CODECS}, got {self.codec!r}")

    @staticmethod
    def ranks(axes: Sequence[Optional[spmd.Axis]]) -> int:
        """The ranks a collective over ``axes`` sums: their sizes'
        product."""
        n = 1
        for a in axes:
            if a is not None:
                n *= a.size
        return n


# ------------------------------------------------------------ comm ledger

class CommLedger:
    """Collective payload bytes recorded while a capture is open:
    ``payload_bytes`` what the quantized collectives put on the wire
    (values and f32 scales), ``reference_bytes`` what their float forms
    would have moved, per site too."""

    def __init__(self):
        self.payload_bytes = 0
        self.reference_bytes = 0
        self.executions = 0
        self.sites: List[Tuple[str, int, int]] = []
        # site -> [payload, reference, executions]
        self.per_site: Dict[str, List[int]] = {}

    def add(self, site: str, payload: int, reference: int,
            executions: int = 1) -> None:
        self.payload_bytes += payload
        self.reference_bytes += reference
        self.executions += executions
        self.sites.append((site, payload, reference))
        tot = self.per_site.setdefault(site, [0, 0, 0])
        tot[0] += payload
        tot[1] += reference
        tot[2] += executions

    @property
    def ratio(self) -> float:
        """reference / payload: at least 2.0 is the relaxed tier's
        contract (for 4-byte payloads)."""
        if self.payload_bytes == 0:
            return float("inf") if self.reference_bytes else 1.0
        return self.reference_bytes / self.payload_bytes

    def report(self) -> Dict:
        return {"payload_bytes": self.payload_bytes,
                "reference_bytes": self.reference_bytes,
                "executions": self.executions,
                "ratio": round(self.ratio, 3) if self.payload_bytes
                else None,
                "sites": len(self.sites),
                "per_site": {s: {"payload_bytes": t[0],
                                 "reference_bytes": t[1],
                                 "executions": t[2]}
                             for s, t in self.per_site.items()}}


_ACTIVE_LEDGERS: List[CommLedger] = []


@contextmanager
def capture_comm():
    """Collect the quantized collectives' byte counts recorded inside
    the ``with``."""
    led = CommLedger()
    _ACTIVE_LEDGERS.append(led)
    try:
        yield led
    finally:
        _ACTIVE_LEDGERS.remove(led)


def _record(site: str, payload: int, reference: int,
            executions: int = 1) -> None:
    if torch._C._current_graph_task_id() != -1:
        return                    # inside a backward: a recompute's
    for led in _ACTIVE_LEDGERS:
        led.add(site, payload, reference, executions)
    record_comm(site, payload, reference, executions)


# ------------------------------------------------------------- primitives

def _scales(amax: torch.Tensor, qmax: float) -> torch.Tensor:
    """``max(amax, _TINY) / qmax`` in f32, as true divisions (the host
    codec's rule)."""
    amax = amax.float()
    return torch.maximum(amax, torch.full_like(amax, _TINY)) / \
        torch.full_like(amax, float(qmax))


def _wire_scales(amax: torch.Tensor, qmax: float) -> torch.Tensor:
    """``max(amax, _TINY) * f32(1 / qmax)``: the collectives' scales, as
    XLA computes the reference's."""
    amax = amax.float()
    return torch.maximum(amax, torch.full_like(amax, _TINY)) * \
        torch.full_like(amax, 1.0 / qmax)


def _pad_rows(x: torch.Tensor, group: int) -> torch.Tensor:
    """x flattened, zero-padded to a multiple of ``group``, as
    ``[G, group]`` rows."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % group
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.view(-1, group)


def _shared_group_scales(rows: torch.Tensor, axes, qmax: float
                         ) -> torch.Tensor:
    """[G] scales: each row's amax, the maximum over ``axes``."""
    amax = rows.float().abs().amax(dim=1)
    for a in axes:
        amax = spmd.pmax_raw(amax, a)
    return _wire_scales(amax, qmax)


def _wire_for(n_ranks: int) -> Tuple[torch.dtype, int]:
    """(wire dtype, per-rank qmax) with headroom for ``n_ranks``
    summands: int8 to 127 ranks, int16 to 32767, then an error."""
    if n_ranks <= 127:
        return torch.int8, max(1, 127 // n_ranks)
    if n_ranks > 32767:
        raise ValueError(f"quantized collective over {n_ranks} ranks "
                         f"overflows the int16 wire — widen the codec")
    return torch.int16, max(1, 32767 // n_ranks)


def _quant_rows(rows: torch.Tensor, scales: torch.Tensor, qmax: float,
                wire: torch.dtype = torch.int8) -> torch.Tensor:
    """``clip(rint(rows / scales), -qmax, qmax)`` in the wire dtype."""
    q = torch.round(rows.float() / scales[:, None])
    return torch.clamp(q, -qmax, qmax).to(wire)


def _to_f8(rows: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return (rows.float() / scales[:, None]).to(_F8)


def _live(axes) -> Tuple[spmd.Axis, ...]:
    return tuple(a for a in axes if a is not None and a.size > 1)


def _gather_rows(x: torch.Tensor, axes) -> torch.Tensor:
    """Every rank's ``x`` stacked in mixed-radix order over ``axes``
    (the last axis gathered first): ``[prod(sizes), *x.shape]``."""
    buf = x[None]
    for a in reversed(axes):
        buf = spmd.all_gather_raw(buf, a, 0)
    return buf


# --------------------------------------------------------- quantized psum

def _psum_quantized_impl(x, axes, rq: RelaxedQuant, scale: str,
                         site: str) -> torch.Tensor:
    n = rq.ranks(axes)
    group = x.numel() if scale == "tensor" else max(1, rq.group)
    rows = _pad_rows(x, group)
    if rq.codec == "fp8" and len(axes) == 1:
        # an fp8 sum on the wire would spend the bits it saves: gather
        # the payloads and add them here, in f32 (exact)
        scales = _shared_group_scales(rows, axes, _F8_MAX)
        f8 = _to_f8(rows, scales)
        gat = spmd.all_gather_raw(f8[None], axes[0], 0).float()
        acc = gat[0].clone()
        for i in range(1, gat.shape[0]):
            acc += gat[i]
        out = acc * scales[:, None]
        _record(site, static_nbytes(f8) + static_nbytes(scales),
                static_nbytes(x))
    else:
        wire, qmax = _wire_for(n)
        scales = _shared_group_scales(rows, axes, qmax)
        q = _quant_rows(rows, scales, qmax, wire)
        s = q
        for a in axes:
            s = spmd.psum_raw(s, a)
        out = s.float() * scales[:, None]
        _record(site, static_nbytes(q) + static_nbytes(scales),
                static_nbytes(x))
    return out.reshape(-1)[:x.numel()].view(x.shape).to(x.dtype)


class _PsumQuantized(torch.autograd.Function):
    """Forward: the quantized sum; backward: the exact psum's transpose,
    the identity (the sum is the same on every rank and counts once)."""

    @staticmethod
    def forward(fctx, x, axes, rq, scale, site):
        return _psum_quantized_impl(x, axes, rq, scale, site)

    @staticmethod
    def backward(fctx, g):
        return g, None, None, None, None


def psum_quantized(x: torch.Tensor, axes, rq: RelaxedQuant, *,
                   scale: str = "group", site: str = "psum"
                   ) -> torch.Tensor:
    """Relaxed psum over ``axes`` (``spmd.Axis``; one shared scale over
    all of them, headroom for their product of ranks): int8 (or fp8)
    payload and shared scales. ``scale="group"``: one scale per
    ``rq.group`` elements (a bucket of leaves whose magnitudes differ);
    ``"tensor"``: one scale (one layer's activations). x's shape and
    dtype; allclose to the exact sum, never bitwise. An integer tensor,
    or a sum over one rank, takes the exact psum."""
    axes = _live(axes)
    if not axes:
        return x
    if not x.is_floating_point():
        for a in axes:
            x = spmd.psum(x, a)
        return x
    return _PsumQuantized.apply(x, axes, rq, scale, site)


# ------------------------------------------------ quantized reduce-scatter

def _scatter_tensor_impl(v, scatter_axis, rq, rest, dim, site):
    all_axes = rest + (scatter_axis,)
    wire, qmax = _wire_for(rq.ranks(all_axes))
    amax = v.float().abs().amax()
    for a in all_axes:
        amax = spmd.pmax_raw(amax, a)
    s0 = _wire_scales(amax, qmax)
    q = torch.clamp(torch.round(v.float() / s0), -qmax, qmax).to(wire)
    for a in rest:
        q = spmd.psum_raw(q, a)
    sl = spmd.psum_scatter_raw(q, scatter_axis, dim)
    _record(site, static_nbytes(q) + 4, static_nbytes(v))
    return (sl.float() * s0).to(v.dtype)


def _scatter_group_impl(x, scatter_axis, rq, rest, site):
    z, k = x.shape
    all_axes = rest + (scatter_axis,)
    wire, qmax = _wire_for(rq.ranks(all_axes))
    group = min(max(1, rq.group), k)
    pad = (-k) % group
    buf = torch.nn.functional.pad(x, (0, pad)) if pad else x
    g = buf.shape[1] // group
    rows = buf.reshape(z * g, group)
    scales = _shared_group_scales(rows, all_axes, qmax)      # [z*g]
    q = _quant_rows(rows, scales, qmax, wire).view(z, g * group)
    for a in rest:
        q = spmd.psum_raw(q, a)
    sl = spmd.psum_scatter_raw(q, scatter_axis, 0).view(g, group)
    mine = scales.view(z, g)[scatter_axis.index]
    out = sl.float() * mine[:, None]
    _record(site, static_nbytes(q) + static_nbytes(scales),
            static_nbytes(x))
    return out.reshape(-1)[:k].to(x.dtype)


class _PsumScatterQuantized(torch.autograd.Function):
    """Forward: the quantized reduce-scatter; backward: the exact one's
    transpose, an all-gather of the cotangent over the scatter axis."""

    @staticmethod
    def forward(fctx, x, scatter_axis, rq, rest, dim, scale, site):
        fctx.args = (scatter_axis, dim, scale, tuple(x.shape))
        if scale == "tensor":
            return _scatter_tensor_impl(x, scatter_axis, rq, rest, dim,
                                        site)
        return _scatter_group_impl(x, scatter_axis, rq, rest, site)

    @staticmethod
    def backward(fctx, g):
        axis, dim, scale, shape = fctx.args
        if scale == "tensor":
            full = spmd.all_gather_raw(g, axis, dim)
        else:
            k = shape[1]
            row = torch.nn.functional.pad(g, (0, k - g.numel()))
            full = spmd.all_gather_raw(row[None], axis, 0)
        return full, None, None, None, None, None, None


def psum_scatter_quantized(x: torch.Tensor, scatter_axis: spmd.Axis,
                           rq: RelaxedQuant, *, rest_axes=(),
                           scatter_dimension: int = 0,
                           scale: str = "group", site: str = "scatter"
                           ) -> torch.Tensor:
    """Relaxed sum over ``rest_axes`` and reduce-scatter over
    ``scatter_axis``. ``scale="group"`` takes the ZeRO-1 bucket layout
    (``[Z, K]``, scattered on dim 0), one scale per (row, group of K),
    and returns this rank's ``(K,)`` slice dequantized with its own
    row's scales; ``"tensor"``: any layout and dim, one scale (the
    Megatron-SP activation scatter). The sum is on the wire, so the fp8
    codec takes the int8 wire here, as the reference's does."""
    rest = _live(rest_axes)
    if scale != "tensor" and (x.dim() != 2 or scatter_dimension != 0):
        raise ValueError("group-scaled quantized scatter needs the "
                         "[Z, K] bucket layout (scatter_dimension=0)")
    return _PsumScatterQuantized.apply(x, scatter_axis, rq, rest,
                                       scatter_dimension % x.dim(), scale,
                                       site)


# --------------------------------------------------- quantized ZeRO-1 gather

class _GatherQuantized(torch.autograd.Function):
    """Forward: every rank's row through the quantized wire, as
    ``[Z, Kp]``; backward: the exact gather's transpose, this rank's row
    of the cotangent."""

    @staticmethod
    def forward(fctx, row, z, idx, axes, rq, site):
        fctx.args = (idx, row.numel())
        k = row.numel()
        group = min(max(1, rq.group), k)
        rows = _pad_rows(row, group)
        g, kp = rows.shape[0], rows.numel()
        if rq.codec == "fp8":
            scales = _shared_group_scales(rows, (), _F8_MAX)  # local amax
            payload = _to_f8(rows, scales).view(kp)
        else:
            scales = _shared_group_scales(rows, (), 127.0)
            payload = _quant_rows(rows, scales, 127.0).view(kp)
        buf = _gather_rows(payload, axes)                    # [Z, Kp]
        sbuf = _gather_rows(scales, axes)                    # [Z, G]
        # + 0: the reference's sum of the holder's value and zeros turns
        # an fp8 -0 into +0
        out = (buf.float() + 0.0).view(z, g, group) * sbuf[:, :, None]
        # the reference's wire: its whole [Z, Kp] buffer and [Z, G]
        # scale plane, against the [Z, Kp] buffer in the row's dtype
        _record(site, static_nbytes(buf) + static_nbytes(sbuf),
                z * kp * row.element_size())
        return out.view(z, kp).to(row.dtype)

    @staticmethod
    def backward(fctx, g):
        idx, k = fctx.args
        return g[idx, :k], None, None, None, None, None


def psum_of_scatter_quantized(row: torch.Tensor, z: int, idx: int, axes,
                              rq: RelaxedQuant, *, site: str = "gather"
                              ) -> torch.Tensor:
    """Relaxed ZeRO-1 gather: every rank's ``(K,)`` updated slice (this
    rank's is ``row``, at mixed-radix position ``idx`` over ``axes``)
    through a quantized wire. One rank holds each element, so nothing
    is summed and the full ±127 range (or a true fp8 value) applies; the
    scales are the holder's, on a small f32 plane beside. Returns the
    dequantized ``[Z, K_padded]`` rows (the caller cuts its leaves)."""
    return _GatherQuantized.apply(row, z, idx, _live(axes), rq, site)


# ------------------------------------------ MoE expert all-to-all payloads

def _expert_fwd(x, axis, split, concat, site):
    flat = x.reshape(-1, x.shape[-1])
    # the exchange takes the collectives' scale rule (the reference's,
    # bit for bit); the single-device round trip keeps the host codec's
    # division, the bits the serving engine's gates were measured on
    # (ROADMAP Queue C 14)
    rule = _scales if axis is None else _wire_scales
    scales = rule(flat.float().abs().amax(dim=1), 127.0)
    q = _quant_rows(flat, scales, 127.0).view(x.shape)
    s = scales.view(x.shape[:-1])
    _record(site, static_nbytes(q) + static_nbytes(s), static_nbytes(x))
    if axis is not None:
        # the scale plane rides the same exchange, one dim short
        q = spmd.all_to_all_raw(q, axis, split, concat)
        s = spmd.all_to_all_raw(s, axis, split, concat)
    return (q.float() * s[..., None]).to(x.dtype)


class _ExpertPayload(torch.autograd.Function):
    """Forward: the int8 round trip (and exchange); backward: the exact
    exchange's transpose, the inverse all-to-all."""

    @staticmethod
    def forward(fctx, x, axis, split, concat, site):
        fctx.args = (axis, split, concat)
        return _expert_fwd(x, axis, split, concat, site)

    @staticmethod
    def backward(fctx, g):
        axis, split, concat = fctx.args
        if axis is not None:
            g = spmd.all_to_all_raw(g, axis, concat, split)
        return g, None, None, None, None


def _expert_payload_quantized(x: torch.Tensor, site: str,
                              axis: Optional[spmd.Axis], *, split_axis: int,
                              concat_axis: int) -> torch.Tensor:
    """An ``[E, C, D]`` expert payload as int8 with one f32 scale per
    (expert, slot) row, exchanged over ``axis`` (the ep axis; None: a
    single-device replica, the exchange is the identity) and
    dequantized on the far side. Records the wire form at the
    ``moe.*`` site."""
    live = axis if axis is not None and axis.size > 1 else None
    return _ExpertPayload.apply(x, live, split_axis, concat_axis, site)


def moe_dispatch_quantized(xe: torch.Tensor,
                           axis: Optional[spmd.Axis] = None) -> torch.Tensor:
    """The dispatch leg: expert inputs ``[E, C, D]`` (to ``[E/ep, ep·C,
    D]`` over an ep axis) as int8 + row scales, at ``moe.dispatch``."""
    return _expert_payload_quantized(xe, "moe.dispatch", axis,
                                     split_axis=0, concat_axis=1)


def moe_combine_quantized(ye: torch.Tensor,
                          axis: Optional[spmd.Axis] = None) -> torch.Tensor:
    """The combine leg: expert outputs back to their tokens' owners (the
    reverse exchange) as int8 + row scales, at ``moe.combine``."""
    return _expert_payload_quantized(ye, "moe.combine", axis,
                                     split_axis=1, concat_axis=0)


# ------------------------------------------------------ host-side codec

_PAYLOAD_VERSION = 1


def quantize_array(x: torch.Tensor, codec: str = "int8",
                   group: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-group quantization of ``x`` (any shape, any float
    dtype; widened to f32 first, exactly) on ``x``'s device, at full
    range (±127, or ±240 for fp8). Returns ``(q [G, group], scales f32
    [G])``, ``q`` int8 or ``float8_e4m3fn``, ``G = ceil(x.numel() /
    group)``; the last group is zero-padded, and an all-zeros group
    decodes to exact zeros."""
    if codec not in WIRE_CODECS:
        raise ValueError(f"unknown wire codec {codec!r} "
                         f"(must be one of {WIRE_CODECS})")
    rows = _pad_rows(x.float(), group)
    if codec == "fp8":
        scales = _scales(rows.abs().amax(dim=1), _F8_MAX)
        return _to_f8(rows, scales), scales
    scales = _scales(rows.abs().amax(dim=1), 127.0)
    return _quant_rows(rows, scales, 127), scales


def dequantize_array(q: torch.Tensor, scales: torch.Tensor,
                     shape: Sequence[int], dtype: torch.dtype
                     ) -> torch.Tensor:
    """Inverse of :func:`quantize_array`: ``q * scale`` in f32, cut to
    ``shape`` and cast to ``dtype``."""
    rows = q.float() * scales.float()[:, None]
    n = 1
    for d in shape:
        n *= int(d)
    return rows.reshape(-1)[:n].reshape(tuple(shape)).to(dtype)


def _dtype_name(d) -> str:
    """A dtype's name as the reference's header writes it ("float32",
    "bfloat16", ...), from a torch dtype, a numpy dtype or a name."""
    if isinstance(d, torch.dtype):
        return str(d).replace("torch.", "")
    if isinstance(d, str):
        return d
    return str(np.dtype(d))


def _host_tensor(x) -> Tuple[torch.Tensor, str]:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu(), _dtype_name(x.dtype)
    return torch.from_numpy(np.asarray(x, np.float32)), \
        _dtype_name(np.asarray(x).dtype)


def encode_payload(x, codec: str = "int8", group: int = 1024) -> bytes:
    """One quantized payload with a self-describing header (``u32 BE
    length || JSON || q bytes || scale bytes``); ``x`` a tensor or a
    numpy array. The header pins codec, dtype and shape, so a reader
    configured otherwise fails loudly."""
    t, name = _host_tensor(x)
    q, scales = quantize_array(t, codec=codec, group=group)
    header = {"v": _PAYLOAD_VERSION, "codec": codec, "group": group,
              "dtype": name, "shape": list(t.shape)}
    hj = json.dumps(header, separators=(",", ":")).encode()
    qb = q.view(torch.uint8) if q.dtype == _F8 else q
    return struct.pack(">I", len(hj)) + hj + qb.numpy().tobytes() + \
        scales.numpy().astype("<f4").tobytes()


def decode_payload(data: bytes, *, codec: Optional[str] = None,
                   shape=None, dtype=None) -> Tuple[torch.Tensor, dict]:
    """Inverse of :func:`encode_payload`: ``(tensor on the CPU in the
    header's dtype, header)``; an expectation (codec, shape, dtype)
    that disagrees with the header raises."""
    if len(data) < 4:
        raise ValueError("truncated lowp payload (no header length)")
    (hlen,) = struct.unpack(">I", data[:4])
    header = json.loads(data[4:4 + hlen].decode())
    if header.get("v") != _PAYLOAD_VERSION:
        raise ValueError(f"lowp payload version {header.get('v')!r} "
                         f"(expected {_PAYLOAD_VERSION})")
    if codec is not None and header["codec"] != codec:
        raise ValueError(f"lowp payload codec {header['codec']!r} != "
                         f"expected {codec!r}")
    hshape = tuple(header["shape"])
    if shape is not None and hshape != tuple(shape):
        raise ValueError(f"lowp payload shape {hshape} != {tuple(shape)}")
    if dtype is not None and header["dtype"] != _dtype_name(dtype):
        raise ValueError(f"lowp payload dtype {header['dtype']} != "
                         f"{_dtype_name(dtype)}")
    group = int(header["group"])
    n = 1
    for d in hshape:
        n *= int(d)
    g = -(-n // group)
    body = data[4 + hlen:]
    if len(body) != g * group + g * 4:
        raise ValueError("truncated lowp payload body")
    raw = torch.frombuffer(bytearray(body[:g * group]), dtype=torch.uint8)
    q = raw.view(_F8) if header["codec"] == "fp8" else raw.view(torch.int8)
    scales = torch.from_numpy(
        np.frombuffer(body[g * group:], "<f4").astype(np.float32))
    out = dequantize_array(q.view(g, group), scales, hshape,
                           getattr(torch, header["dtype"]))
    return out, header
