"""The compressed bitstream — the serialization layer the reference stopped
short of (it only printed quantization statistics, ``main.cpp:106-140``).

Per-item payload mirrors ``encode_item_t`` (``encode/datatypes.h:20-23``)
minus everything recoverable by index arithmetic: for a uniform grid the
range geometry is implied by the item's position in the stream, so each item
stores only

    valid (1 bit) | domain_idx (ceil(log2 D) bits) | transform (t bits) |
    s_q (s_bits) | o_q (o_bits)

packed MSB-first.  The header carries the image/grid geometry and the (s, o)
quantizer ranges.  A numpy bit-matrix + ``packbits`` keeps the host-side
pack/unpack vectorized; a C++ packer can replace it behind the same API if
host CPU becomes the bottleneck.

File layout: magic 'FTC1', then little-endian u32/f32 header fields, then the
bit-packed payload.
"""
from __future__ import annotations

import dataclasses
import struct

import numpy as np

from .quantize import DEFAULT_O_BITS, DEFAULT_S_BITS, dequantize, quantize

__all__ = ["pack_result", "unpack_result", "BitstreamHeader"]

_MAGIC = b"FTC1"
# v1: fixed-width packed items.  v2 (round 5): declared whenever the payload
# is entropy-coded (flag bit 1) so a pre-entropy reader fails loudly on the
# version instead of silently mis-parsing Huffman bytes as fixed-width items
# (round 4 signalled entropy by flag alone; those v1-entropy files are still
# accepted — the flag is honored for both versions).
_VERSION = 1
_VERSION_ENTROPY = 2


def _bit_width(n: int) -> int:
    return max(int(n - 1).bit_length(), 1)


@dataclasses.dataclass
class BitstreamHeader:
    width: int
    height: int
    source_size: int
    target_size: int
    domain_step: int
    s_bits: int
    o_bits: int
    s_min: float
    s_max: float
    o_min: float
    o_max: float
    num_ranges: int
    num_domains: int


_HDR_FMT = "<4sHHIIHHHHHxx ffff I I".replace(" ", "")


def _ints_to_bits(vals: np.ndarray, width: int) -> np.ndarray:
    """[N] uint -> [N, width] bits, MSB first."""
    shifts = np.arange(width - 1, -1, -1, dtype=np.uint32)
    return ((vals[:, None].astype(np.uint64) >> shifts[None, :]) & 1).astype(np.uint8)


def _bits_to_ints(bits: np.ndarray) -> np.ndarray:
    """[N, width] bits (MSB first) -> [N] uint64."""
    width = bits.shape[1]
    shifts = np.arange(width - 1, -1, -1, dtype=np.uint64)
    return (bits.astype(np.uint64) << shifts[None, :]).sum(axis=1)


_FLAG_O_IS_MEAN = 1
# round 4: entropy-coded payload (codec/entropy.py) — per-field canonical
# Huffman streams instead of fixed-width packed items
_FLAG_ENTROPY = 2
# all items valid: the validity bitmask is omitted entirely
_FLAG_ALL_VALID = 4
# round 5: flat-block short-circuit.  Items whose |s| is within half a
# quantizer bucket of zero decode as s = 0 exactly (a flat block: the
# output is just o), so their domain/transform fields carry no information
# and are OMITTED from those streams.  The s stream signals them with the
# extra symbol ``1 << s_bits``.  Error-neutral by construction: replacing
# s by 0 perturbs s by <= bucket/2 — the quantizer's own worst-case error —
# and only for blocks the encoder already deemed almost flat.  Measured
# ~16-23% of items at the default 5-bit budget => ~2 bits/item saved
# (measured on bits and PSNR, which do not depend on the device).
_FLAG_FLAT_SC = 8
# flags bits 4-7: num_transforms the search considered (0 = legacy -> 8);
# lets the decoder build gather tables for only the searched isometries
_NT_SHIFT = 4


def _o_predict_deltas(o_q: np.ndarray, row_len: int) -> np.ndarray:
    """Prediction residuals for o_q: row-above predictor when the items form
    a [ny, row_len] grid (adjacent rows have similar brightness: measured
    ~4.3 vs ~5.1 bits/item for the 1-D delta), else previous-item delta."""
    o = o_q.astype(np.int64)
    if row_len > 0 and len(o) % row_len == 0 and len(o) > row_len:
        o2 = o.reshape(-1, row_len)
        d = o2 - np.vstack([np.concatenate([[0], o2[0, :-1]]), o2[:-1]])
        return d.reshape(-1)
    return np.diff(o, prepend=0)


def _o_reconstruct(deltas: np.ndarray, row_len: int) -> np.ndarray:
    d = deltas.astype(np.int64)
    if row_len > 0 and len(d) % row_len == 0 and len(d) > row_len:
        d2 = d.reshape(-1, row_len).copy()
        d2[0] = np.cumsum(d2[0])
        return np.cumsum(d2, axis=0).reshape(-1)
    return np.cumsum(d)


def _encode_dom(dom, d_bits: int) -> bytes:
    """Domain-index field: JOINT range-coded stream vs byte-plane Huffman,
    whichever is smaller.

    The byte-planar split costs the cross-byte correlation (measured ~0.7
    bits/item at 512^2: planes 11.90 vs joint H 11.23); the adaptive range
    coder's bit tree models the full 2**d_bits alphabet directly.  The
    decoder distinguishes the forms by the first stream's mode byte and
    the mode-2 frame's nbits field (joint streams carry nbits == d_bits;
    a byte plane that happens to win range coding carries nbits == 8, and
    at d_bits == 8 the two coincide exactly)."""
    from .entropy import _RC_MAX_NBITS, encode_stream, encode_uint_stream

    nb = (d_bits + 7) // 8
    dom64 = dom.astype(np.uint64)
    planes = b"".join(
        encode_stream(((dom64 >> (8 * j)) & 0xFF).astype(np.uint8))
        for j in range(nb)
    )
    if len(dom) >= 64 and 1 <= d_bits <= _RC_MAX_NBITS:
        joint = encode_uint_stream(dom.astype(np.uint32), d_bits)
        if len(joint) < len(planes):
            return joint
    return planes


def _decode_dom(data: bytes, offset: int, n_code: int, d_bits: int):
    """Mirror of ``_encode_dom``: peek the first stream's framing to pick
    the joint or byte-plane form."""
    from .entropy import decode_stream, decode_uint_stream

    if (len(data) >= offset + 6 and data[offset] == 2
            and data[offset + 5] == d_bits):
        vals, offset = decode_uint_stream(data, offset, expect_count=n_code,
                                          expect_nbits=d_bits)
        return vals.astype(np.uint64), offset
    nb = (d_bits + 7) // 8
    dom = np.zeros(n_code, np.uint64)
    for j in range(nb):
        plane, offset = decode_stream(data, offset, expect_count=n_code)
        dom |= plane.astype(np.uint64) << (8 * j)
    return dom, offset


def _entropy_pack_fields(dom, tr, s_q, o_q, valid, d_bits,
                         row_len: int = 0, flat=None,
                         flat_sym: int = 0) -> bytes:
    """Per-field entropy streams: validity bitmask (raw bytes, framed),
    the domain-index field (raw values — winners are spatially
    uncorrelated, delta AND locality-recentered coding both measurably
    hurt, measured on bits and PSNR — coded as a joint range stream or
    byte-plane Huffman, see ``_encode_dom``), transform, s_q, and zigzag
    prediction residuals of o_q (a >8-bit range stream when o_bits == 8).

    ``flat`` ([n] bool or None): flat-short-circuit mask.  When given, the
    s stream comes FIRST and marks flat items with ``flat_sym``; the domain
    byte planes and transform stream then carry only the non-flat items
    (the decoder learns their count from the s stream)."""
    from .entropy import encode_stream, zigzag

    parts = []
    if not valid.all():
        parts.append(encode_stream(np.packbits(valid.astype(np.uint8))))
    if flat is not None:
        s_sym = np.where(flat, flat_sym, s_q).astype(np.uint8)
        parts.append(encode_stream(s_sym))
        keep = ~flat
        dom = dom[keep]
        tr = tr[keep]
    parts.append(_encode_dom(dom, d_bits))
    parts.append(encode_stream(tr.astype(np.uint8)))
    if flat is None:
        parts.append(encode_stream(s_q.astype(np.uint8)))
    od = zigzag(_o_predict_deltas(o_q, row_len))
    if od.size and int(od.max()) > 255:
        # wide o quantizers (o_bits == 8): the zigzag residuals exceed the
        # byte alphabet — a joint range-coded stream covers them (the
        # decoder dispatches on the mode-2 frame's nbits != 8)
        from .entropy import encode_uint_stream

        parts.append(encode_uint_stream(od.astype(np.uint32),
                                        int(od.max()).bit_length()))
    else:
        parts.append(encode_stream(od.astype(np.uint8)))
    return b"".join(parts)


def _entropy_unpack_fields(data: bytes, offset: int, n: int, d_bits: int,
                           all_valid: bool, row_len: int = 0,
                           flat_sym: int | None = None):
    """Mirror of ``_entropy_pack_fields``.  With ``flat_sym`` (flat
    short-circuit active) the returned s_q may contain that symbol; flat
    items get dom = 0, tr = 0 and must decode as s = 0."""
    from .entropy import decode_stream, unzigzag

    if all_valid:
        valid = np.ones(n, bool)
    else:
        vb, offset = decode_stream(data, offset, expect_count=(n + 7) // 8)
        valid = np.unpackbits(vb, count=n).astype(bool)
    flat = None
    if flat_sym is not None:
        s_q, offset = decode_stream(data, offset, expect_count=n)
        flat = s_q == flat_sym
        n_code = int((~flat).sum())
    else:
        n_code = n
    dom_c, offset = _decode_dom(data, offset, n_code, d_bits)
    tr_c, offset = decode_stream(data, offset, expect_count=n_code)
    if flat_sym is None:
        s_q, offset = decode_stream(data, offset, expect_count=n)
    if (len(data) >= offset + 6 and data[offset] == 2
            and data[offset + 5] != 8):
        from .entropy import decode_uint_stream

        od, offset = decode_uint_stream(data, offset, expect_count=n)
    else:
        od, offset = decode_stream(data, offset, expect_count=n)
    o_q = _o_reconstruct(unzigzag(od.astype(np.uint32)), row_len)
    if flat is not None:
        dom = np.zeros(n, np.uint64)
        tr = np.zeros(n, np.uint8)
        dom[~flat] = dom_c
        tr[~flat] = tr_c
    else:
        dom, tr = dom_c, tr_c
    return dom, tr.astype(np.uint32), s_q.astype(np.uint32), \
        o_q.astype(np.uint32), valid, offset


def pack_result(
    result,
    s_bits: int = DEFAULT_S_BITS,
    o_bits: int = DEFAULT_O_BITS,
    plane=None,
    entropy: bool = True,
    flat_scale: float = 0.35,
) -> bytes:
    """Serialize an ``EncodeResult`` to the compressed byte stream.

    ``entropy=True`` (default) entropy-codes the payload with per-field
    canonical Huffman streams (``codec/entropy.py``) whenever that beats the
    fixed-width packing; the header flag records which form was written and
    the decoder auto-detects.

    If ``plane`` (the source image, [H, W] u8) is given, the stream stores
    the mean-centred parameterization: 'o' becomes each range block's target
    mean and the decoder applies ``s*(D - mean(D)) + mean``.  This bounds the
    o-quantization error to ~step/2 gray levels directly, instead of letting
    s-quantization error multiply full-magnitude pixels — worth >5 dB at the
    reference's 5/7 bit budget.
    """
    o_is_mean = plane is not None
    s = np.asarray(result.s, dtype=np.float64)
    if o_is_mean:
        p = np.asarray(plane, dtype=np.float64)
        tw = result.target_size
        h, w = p.shape
        o = (
            p.reshape(h // tw, tw, w // tw, tw)
            .transpose(0, 2, 1, 3)
            .reshape(-1, tw * tw)
            .mean(axis=1)
        )
    else:
        o = np.asarray(result.o, dtype=np.float64)
    valid = np.asarray(result.valid)
    dom = np.asarray(result.domain_idx, dtype=np.uint32)
    tr = np.asarray(result.transform, dtype=np.uint32)

    num_domains = result.domain_grid.num_items
    # Robust quantizer ranges: unclamped least-squares s explodes on
    # near-flat domains (den ~ 0), and a single outlier would stretch the
    # uniform buckets until every normal block collapses into one bucket.
    # Clip the range at the 0.5/99.5 percentiles; outliers saturate (they are
    # non-contractive, low-quality matches anyway).
    if s.size:
        s_min, s_max = (float(x) for x in np.percentile(s, [0.5, 99.5]))
        o_min, o_max = (float(x) for x in np.percentile(o, [0.5, 99.5]))
    else:
        s_min = s_max = o_min = o_max = 0.0

    s_q = quantize(s, s_min, s_max, s_bits)
    o_q = quantize(o, o_min, o_max, o_bits)

    d_bits = _bit_width(num_domains)
    t_bits = 3
    from .native import pack_items_native

    payload = pack_items_native(dom, tr, s_q, o_q, valid, d_bits, t_bits,
                                s_bits, o_bits)
    if payload is None:  # no compiler available: numpy fallback
        bits = np.concatenate(
            [
                valid.astype(np.uint8)[:, None],
                _ints_to_bits(dom, d_bits),
                _ints_to_bits(tr, t_bits),
                _ints_to_bits(s_q, s_bits),
                _ints_to_bits(o_q, o_bits),
            ],
            axis=1,
        )
        payload = np.packbits(bits.reshape(-1)).tobytes()

    flags = (
        (_FLAG_O_IS_MEAN if o_is_mean else 0)
        | (getattr(result, "num_transforms", 8) << _NT_SHIFT)
    )
    # entropy-coded payload (s in a byte; o up to 8 bits — wider o-deltas
    # ride the mode-2 range coder); keep whichever representation is
    # smaller — entropy never loses
    if entropy and s_bits <= 8 and o_bits <= 8 and len(valid):
        all_valid = bool(valid.all())
        row_len = result.width // result.target_size
        e_payload = _entropy_pack_fields(dom, tr, s_q, o_q, valid, d_bits,
                                         row_len=row_len)
        e_flags = _FLAG_ENTROPY | (_FLAG_ALL_VALID if all_valid else 0)
        # flat short-circuit (see _FLAG_FLAT_SC): |s| within half a bucket
        # of zero decodes as exactly 0, so dom/transform bits are dropped.
        # Invalid items decode as s = 0 anyway — fold them in too.
        if s_bits <= 7 and s_max > s_min and flat_scale > 0:
            bucket = (s_max - s_min) / (1 << s_bits)
            # default 0.35 buckets: measured PSNR-neutral-or-better on the
            # fixtures (0.5 — the worst-case-neutral bound — costs ~0.01-
            # 0.07 dB; 0.35 is at or above the no-flat PSNR at most of the
            # rate win on measured bits)
            flat = (np.abs(s) <= flat_scale * bucket) | ~valid
            if flat.any():
                f_payload = _entropy_pack_fields(
                    dom, tr, s_q, o_q, valid, d_bits, row_len=row_len,
                    flat=flat, flat_sym=1 << s_bits)
                if len(f_payload) < len(e_payload):
                    e_payload = f_payload
                    e_flags |= _FLAG_FLAT_SC
        if len(e_payload) < len(payload):
            payload = e_payload
            flags |= e_flags

    header = struct.pack(
        _HDR_FMT,
        _MAGIC,
        _VERSION_ENTROPY if flags & _FLAG_ENTROPY else _VERSION,
        flags,
        result.width,
        result.height,
        result.source_size,
        result.target_size,
        result.domain_step,
        s_bits,
        o_bits,
        s_min,
        s_max,
        o_min,
        o_max,
        len(valid),
        num_domains,
    )
    return header + payload


def unpack_result(data: bytes):
    """Deserialize to an ``EncodeResult`` with dequantized (midpoint) s, o."""
    import jax.numpy as jnp

    from ..encode.encoder import EncodeResult

    hdr_size = struct.calcsize(_HDR_FMT)
    fields = struct.unpack(_HDR_FMT, data[:hdr_size])
    (magic, version, flags, width, height, source_size, target_size,
     domain_step, s_bits, o_bits, s_min, s_max, o_min, o_max,
     num_ranges, num_domains) = fields
    if magic != _MAGIC or version not in (_VERSION, _VERSION_ENTROPY):
        raise ValueError("bad bitstream header")
    if not (1 <= s_bits <= 16 and 1 <= o_bits <= 16 and width and height
            and target_size):
        raise ValueError("corrupt bitstream header fields")
    o_is_mean = bool(flags & _FLAG_O_IS_MEAN)
    num_transforms = ((flags >> _NT_SHIFT) & 0xF) or 8

    d_bits = _bit_width(num_domains)
    t_bits = 3
    flat_sym = (1 << s_bits) if flags & _FLAG_FLAT_SC else None
    if flags & _FLAG_ENTROPY:
        dom, tr, s_q, o_q, valid, _ = _entropy_unpack_fields(
            data, hdr_size, num_ranges, d_bits,
            bool(flags & _FLAG_ALL_VALID),
            row_len=width // target_size,
            flat_sym=flat_sym,
        )
    else:
        from .native import unpack_items_native

        native = unpack_items_native(data[hdr_size:], num_ranges, d_bits,
                                     t_bits, s_bits, o_bits)
        if native is not None:
            dom, tr, s_q, o_q, valid = native
        else:
            item_bits = 1 + d_bits + t_bits + s_bits + o_bits
            total_bits = num_ranges * item_bits
            bits = np.unpackbits(
                np.frombuffer(data[hdr_size:], dtype=np.uint8), count=total_bits
            ).reshape(num_ranges, item_bits)

            pos = 0
            valid = bits[:, 0].astype(bool); pos += 1
            dom = _bits_to_ints(bits[:, pos : pos + d_bits]); pos += d_bits
            tr = _bits_to_ints(bits[:, pos : pos + t_bits]); pos += t_bits
            s_q = _bits_to_ints(bits[:, pos : pos + s_bits]); pos += s_bits
            o_q = _bits_to_ints(bits[:, pos : pos + o_bits])

    if flat_sym is not None:
        flat = s_q == flat_sym
        s = np.where(flat, 0.0,
                     dequantize(np.minimum(s_q, flat_sym - 1),
                                s_min, s_max, s_bits))
    else:
        s = dequantize(s_q, s_min, s_max, s_bits)
    o = dequantize(o_q, o_min, o_max, o_bits)

    return EncodeResult(
        domain_idx=jnp.asarray(dom, jnp.int32),
        transform=jnp.asarray(tr, jnp.int32),
        s=jnp.asarray(s, jnp.float32),
        o=jnp.asarray(o, jnp.float32),
        distance=jnp.zeros(num_ranges, jnp.float32),
        valid=jnp.asarray(valid),
        width=width,
        height=height,
        source_size=source_size,
        target_size=target_size,
        domain_step=domain_step,
        o_is_mean=o_is_mean,
        num_transforms=num_transforms,
    )
