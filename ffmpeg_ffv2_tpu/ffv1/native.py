"""ctypes bindings to the C++ host runtime (native/ffv1_runtime.cpp).

The native codec is the production host path: identical bitstream to the
scalar Python oracle, slice-threaded, ~1000x faster.  Build happens lazily
via make on first use.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from .params import FFV1Params, CODER_GOLOMB

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libffv1rt.so")

_lib = None
_lib_lock = threading.Lock()


class FFV1ParamsC(ctypes.Structure):
    _fields_ = [
        ("version", ctypes.c_int32),
        ("micro_version", ctypes.c_int32),
        ("width", ctypes.c_int32),
        ("height", ctypes.c_int32),
        ("colorspace", ctypes.c_int32),
        ("bits", ctypes.c_int32),
        ("chroma_planes", ctypes.c_int32),
        ("chroma_h_shift", ctypes.c_int32),
        ("chroma_v_shift", ctypes.c_int32),
        ("transparency", ctypes.c_int32),
        ("ac", ctypes.c_int32),
        ("ec", ctypes.c_int32),
        ("intra", ctypes.c_int32),
        ("context_model", ctypes.c_int32),
        ("num_h_slices", ctypes.c_int32),
        ("num_v_slices", ctypes.c_int32),
        ("plane_count", ctypes.c_int32),
        ("use32bit", ctypes.c_int32),
        ("quant_table_count", ctypes.c_int32),
        ("context_counts", ctypes.c_int32 * 8),
        ("quant_tables", ctypes.c_int16 * (8 * 5 * 256)),
        ("state_transition", ctypes.c_uint8 * 256),
    ]


def _build_lib():
    subprocess.run(["make", "-s", "-C", _NATIVE_DIR], check=True)


def get_lib():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        src = os.path.join(_NATIVE_DIR, "ffv1_runtime.cpp")
        if (not os.path.exists(_LIB_PATH)
                or os.path.getmtime(_LIB_PATH) < os.path.getmtime(src)):
            _build_lib()
        lib = ctypes.CDLL(_LIB_PATH)
        lib.ffv1rt_create.restype = ctypes.c_void_p
        lib.ffv1rt_create.argtypes = [ctypes.POINTER(FFV1ParamsC),
                                      ctypes.c_int]
        lib.ffv1rt_destroy.argtypes = [ctypes.c_void_p]
        lib.ffv1rt_encode.restype = ctypes.c_int64
        lib.ffv1rt_encode.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
        lib.ffv1rt_decode.restype = ctypes.c_int32
        lib.ffv1rt_decode.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_void_p)]
        lib.ffv1rt_decode_pipelined.restype = ctypes.c_int32
        lib.ffv1rt_decode_pipelined.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32)]
        lib.ffv1rt_slice_damaged.restype = ctypes.c_int32
        lib.ffv1rt_slice_damaged.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.ffv1rt_encode_sym.restype = ctypes.c_int64
        lib.ffv1rt_encode_sym.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
        lib.ffv1rt_set_initial_states.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
        lib.ffv1rt_set_stats_mode.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.ffv1rt_get_stats.restype = ctypes.c_int32
        lib.ffv1rt_get_stats.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64]
        lib.ffv1rt_sort_stt.restype = ctypes.c_int32
        lib.ffv1rt_sort_stt.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint8)]
        lib.ffv1rt_find_best_state.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8)]
        _lib = lib
        return _lib


def params_to_c(p: FFV1Params) -> FFV1ParamsC:
    pc = FFV1ParamsC()
    pc.version = p.version
    pc.micro_version = p.micro_version
    pc.width = p.width
    pc.height = p.height
    pc.colorspace = p.colorspace
    pc.bits = p.bits
    pc.chroma_planes = int(p.chroma_planes)
    pc.chroma_h_shift = p.chroma_h_shift
    pc.chroma_v_shift = p.chroma_v_shift
    pc.transparency = int(p.transparency)
    pc.ac = p.ac
    pc.ec = p.ec
    pc.intra = p.intra
    pc.context_model = p.context_model
    pc.num_h_slices = p.num_h_slices
    pc.num_v_slices = p.num_v_slices
    pc.plane_count = p.plane_count
    pc.use32bit = int(p.use32bit)
    nqt = len(p.context_counts)
    pc.quant_table_count = nqt
    for i, cc in enumerate(p.context_counts):
        pc.context_counts[i] = cc
    qt = np.zeros((8, 5, 256), dtype=np.int16)
    qt[:nqt] = p.quant_tables[:nqt]
    ctypes.memmove(pc.quant_tables, qt.ctypes.data, qt.nbytes)
    st = np.ascontiguousarray(p.state_transition, dtype=np.uint8)
    ctypes.memmove(pc.state_transition, st.ctypes.data, 256)
    return pc


class NativeFFV1Codec:
    """Encoder/decoder session backed by the C++ runtime.

    Planes are int32 numpy arrays in coding order (YUV: y,u,v,(a);
    RGB: g,b,r,(a)).
    """

    def __init__(self, p: FFV1Params, n_threads: int = 0):
        self.p = p
        self.lib = get_lib()
        if n_threads <= 0:
            n_threads = min(os.cpu_count() or 1, p.slice_count)
        pc = params_to_c(p)
        self.handle = self.lib.ffv1rt_create(ctypes.byref(pc), n_threads)
        if not self.handle:
            raise RuntimeError("ffv1rt_create failed")
        if p.initial_states:
            for qt, init in enumerate(p.initial_states):
                if init is not None:
                    arr = np.ascontiguousarray(init, dtype=np.uint8)
                    self.lib.ffv1rt_set_initial_states(
                        self.handle, qt,
                        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                        arr.nbytes)

    def __del__(self):
        if getattr(self, "handle", None):
            self.lib.ffv1rt_destroy(self.handle)
            self.handle = None

    def _plane_ptrs(self, planes):
        arrs = [np.ascontiguousarray(pl, dtype=np.int32) for pl in planes]
        ptrs = (ctypes.c_void_p * len(arrs))(
            *[a.ctypes.data_as(ctypes.c_void_p) for a in arrs])
        return arrs, ptrs

    def encode(self, planes, keyframe: bool) -> bytes:
        arrs, ptrs = self._plane_ptrs(planes)
        cap = 16384 + 4 * 37 * self.p.width * self.p.height
        out = np.empty(cap, dtype=np.uint8)
        n = self.lib.ffv1rt_encode(
            self.handle, ptrs, 1 if keyframe else 0,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
        if n < 0:
            raise RuntimeError("native encode failed")
        return out[:n].tobytes()

    def encode_sym(self, planes, ctx_streams, diff_streams,
                   keyframe: bool) -> bytes:
        """Phase-B entropy coding over precomputed (context, diff) streams
        (one int32 [h, w] pair per coded plane, from the device phase A)."""
        arrs, ptrs = self._plane_ptrs(planes)
        carrs, cptrs = self._plane_ptrs(ctx_streams)
        darrs, dptrs = self._plane_ptrs(diff_streams)
        cap = 16384 + 4 * 37 * self.p.width * self.p.height
        out = np.empty(cap, dtype=np.uint8)
        n = self.lib.ffv1rt_encode_sym(
            self.handle, ptrs, cptrs, dptrs, len(carrs),
            1 if keyframe else 0,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
        if n < 0:
            raise RuntimeError("native encode_sym failed")
        return out[:n].tobytes()

    def decode(self, packet: bytes):
        p = self.p
        shapes = []
        if p.colorspace == 0:
            shapes.append((p.height, p.width))
            if p.chroma_planes:
                cw = -(-p.width >> p.chroma_h_shift)
                ch = -(-p.height >> p.chroma_v_shift)
                shapes += [(ch, cw), (ch, cw)]
            if p.transparency:
                shapes.append((p.height, p.width))
        else:
            shapes = [(p.height, p.width)] * (3 + (1 if p.transparency else 0))
        outs = [np.zeros(s, dtype=np.int32) for s in shapes]
        ptrs = (ctypes.c_void_p * len(outs))(
            *[a.ctypes.data_as(ctypes.c_void_p) for a in outs])
        buf = np.frombuffer(packet, dtype=np.uint8)
        ret = self.lib.ffv1rt_decode(
            self.handle,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(packet), ptrs)
        if ret < 0:
            raise ValueError(f"native decode failed ({ret})")
        return outs

    def _plane_shapes(self):
        p = self.p
        if p.colorspace == 0:
            shapes = [(p.height, p.width)]
            if p.chroma_planes:
                cw = -(-p.width >> p.chroma_h_shift)
                ch = -(-p.height >> p.chroma_v_shift)
                shapes += [(ch, cw), (ch, cw)]
            if p.transparency:
                shapes.append((p.height, p.width))
            return shapes
        return [(p.height, p.width)] * (3 + (1 if p.transparency else 0))

    def decode_pipelined(self, packets):
        """Frame-pipelined decode of a packet sequence (the reference's
        frame-thread analogue, pthread_frame.c:473/558 + ffv1dec.c
        per-slice progress): the native runtime streams each slice
        column through all frames, so consecutive inter frames decode
        concurrently on min(threads, slices) cores — no GOP boundaries
        needed.  Keyframe flags are read from the bitstream itself.
        Returns a list of frames (list of int32 planes each)."""
        n = len(packets)
        shapes = self._plane_shapes()
        np_ = len(shapes)
        outs = [[np.zeros(s, dtype=np.int32) for s in shapes]
                for _ in range(n)]
        bufs = [np.frombuffer(pk, dtype=np.uint8) for pk in packets]
        pkt_ptrs = (ctypes.c_void_p * n)(
            *[b.ctypes.data_as(ctypes.c_void_p) for b in bufs])
        sizes = (ctypes.c_int64 * n)(*[len(pk) for pk in packets])
        plane_ptrs = (ctypes.c_void_p * (n * np_))(
            *[a.ctypes.data_as(ctypes.c_void_p)
              for fr in outs for a in fr])
        status = (ctypes.c_int32 * n)()
        ret = self.lib.ffv1rt_decode_pipelined(
            self.handle,
            ctypes.cast(pkt_ptrs, ctypes.POINTER(ctypes.c_void_p)),
            sizes, n,
            ctypes.cast(plane_ptrs, ctypes.POINTER(ctypes.c_void_p)),
            np_, status)
        if ret < 0:
            raise ValueError(f"native pipelined decode failed ({ret})")
        self.last_status = list(status)
        return outs

    def enable_stats(self):
        self.lib.ffv1rt_set_stats_mode(self.handle, 1)

    def slice_damaged(self, si: int) -> bool:
        return bool(self.lib.ffv1rt_slice_damaged(self.handle, si))
