"""ctypes loader for the native bit-packing library.

Builds ``native/bitpack.cpp`` into a shared object next to the source on
first use, and again whenever the source's content hash differs from the
one recorded beside the binary (a checkout does not preserve mtimes, and
the binary is never committed).  Falls back silently to the numpy
implementation when no compiler is available.  The numpy path stays the
oracle — see ``tests/test_native.py``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

__all__ = ["get_lib", "pack_items_native", "unpack_items_native",
           "decode_huffman_native", "rc_encode_native", "rc_decode_native"]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "bitpack.cpp")
_SO = os.path.join(_REPO_ROOT, "native", "_bitpack.so")
_STAMP = os.path.join(_REPO_ROOT, "native", "_bitpack.sha256")

_lock = threading.Lock()
_lib = None
_lib_checked = False


def _build(src: str, so: str) -> bool:
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-o", tmp, src],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
        return True
    except Exception:
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def _ensure_built(src: str = _SRC, so: str = _SO, stamp: str = _STAMP) -> bool:
    """Build ``so`` from ``src`` unless ``stamp`` records the hash of the
    source it was built from.  Returns whether an up-to-date binary exists."""
    if not os.path.exists(src):
        return False
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if os.path.exists(so) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == digest:
                return True
    if not _build(src, so):
        return False
    with open(stamp, "w") as f:
        f.write(digest + "\n")
    return True


def get_lib():
    """The loaded ctypes library, or None if unavailable."""
    global _lib, _lib_checked
    with _lock:
        if _lib_checked:
            return _lib
        _lib_checked = True
        if not _ensure_built():
            return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.ftc_pack_items.restype = ctypes.c_size_t
        lib.ftc_pack_items.argtypes = [
            ctypes.c_size_t, u32p, u32p, u32p, u32p, u8p,
            ctypes.c_uint, ctypes.c_uint, ctypes.c_uint, ctypes.c_uint, u8p,
        ]
        lib.ftc_unpack_items.restype = None
        lib.ftc_unpack_items.argtypes = [
            ctypes.c_size_t, u8p,
            ctypes.c_uint, ctypes.c_uint, ctypes.c_uint, ctypes.c_uint,
            u32p, u32p, u32p, u32p, u8p,
        ]
        if hasattr(lib, "ftc_huffman_decode"):
            lib.ftc_huffman_decode.restype = ctypes.c_int
            lib.ftc_huffman_decode.argtypes = [
                u8p, ctypes.c_size_t, ctypes.c_size_t, u8p, u8p,
                ctypes.c_size_t,
            ]
        if hasattr(lib, "ftc_rc_encode_tree"):
            lib.ftc_rc_encode_tree.restype = ctypes.c_size_t
            lib.ftc_rc_encode_tree.argtypes = [
                u32p, ctypes.c_size_t, ctypes.c_uint, u8p, ctypes.c_size_t,
            ]
            lib.ftc_rc_decode_tree.restype = ctypes.c_int
            lib.ftc_rc_decode_tree.argtypes = [
                u8p, ctypes.c_size_t, ctypes.c_uint, u32p, ctypes.c_size_t,
            ]
        _lib = lib
        return _lib


def pack_items_native(dom, tr, sq, oq, valid, d_bits, t_bits, s_bits, o_bits):
    """Pack item fields to bytes, or None if the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(dom)
    total_bits = n * (1 + d_bits + t_bits + s_bits + o_bits)
    out = np.zeros((total_bits + 7) // 8, dtype=np.uint8)
    written = lib.ftc_pack_items(
        n,
        np.ascontiguousarray(dom, np.uint32),
        np.ascontiguousarray(tr, np.uint32),
        np.ascontiguousarray(sq, np.uint32),
        np.ascontiguousarray(oq, np.uint32),
        np.ascontiguousarray(valid, np.uint8),
        d_bits, t_bits, s_bits, o_bits,
        out,
    )
    assert written == len(out), (written, len(out))
    return out.tobytes()


def decode_huffman_native(payload: bytes, n_bits: int, n_syms: int,
                          lengths) -> "np.ndarray | None":
    """Canonical-Huffman symbol-serial decode (the host-bound hot loop of
    ``codec.entropy.decode_stream``), or None if the native lib is
    unavailable or predates the entropy entry point."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "ftc_huffman_decode"):
        return None
    out = np.empty(n_syms, np.uint8)
    # read-only view: the C side only reads the payload (const scan loop in
    # native/bitpack.cpp), so no defensive copy — multi-plane/quadtree files
    # decode many per-field streams and the copies were pure overhead
    rc = lib.ftc_huffman_decode(
        np.frombuffer(payload, np.uint8), len(payload),
        ctypes.c_size_t(n_bits),
        np.ascontiguousarray(lengths, np.uint8),
        out, ctypes.c_size_t(n_syms),
    )
    if rc != 0:
        raise ValueError("corrupt huffman payload")
    return out


def rc_encode_native(vals, nbits: int) -> "bytes | None":
    """Bit-tree range encode (codec.entropy stream mode 2), or None when
    the native lib is unavailable or predates the entry point."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "ftc_rc_encode_tree"):
        return None
    v = np.ascontiguousarray(vals, np.uint32)
    # worst case ~nbits/8 bytes per symbol plus flush; adaptive coding of
    # adversarial data can exceed the entropy slightly, pad generously
    cap = len(v) * ((nbits + 7) // 8 + 1) + 64
    out = np.empty(cap, np.uint8)
    written = lib.ftc_rc_encode_tree(v, len(v), nbits, out, cap)
    if written == 0 and len(v) > 0:
        return None  # capacity overflow: let the oracle handle it
    return out[:written].tobytes()


def rc_decode_native(payload: bytes, nbits: int, n: int
                     ) -> "np.ndarray | None":
    lib = get_lib()
    if lib is None or not hasattr(lib, "ftc_rc_decode_tree"):
        return None
    out = np.empty(n, np.uint32)
    rc = lib.ftc_rc_decode_tree(
        np.frombuffer(payload, np.uint8), len(payload), nbits, out, n)
    if rc != 0:
        raise ValueError("corrupt range-coded payload")
    return out


def unpack_items_native(data: bytes, n, d_bits, t_bits, s_bits, o_bits):
    """Unpack to (dom, tr, sq, oq, valid) arrays, or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    dom = np.empty(n, np.uint32)
    tr = np.empty(n, np.uint32)
    sq = np.empty(n, np.uint32)
    oq = np.empty(n, np.uint32)
    valid = np.empty(n, np.uint8)
    buf = np.frombuffer(data, dtype=np.uint8)  # read-only; C side only reads
    lib.ftc_unpack_items(n, buf, d_bits, t_bits, s_bits, o_bits,
                         dom, tr, sq, oq, valid)
    return dom, tr, sq, oq, valid.astype(bool)
