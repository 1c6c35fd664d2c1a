"""Image files to (H, W, 3) uint8 RGB on the host, without PIL (the port's
counterpart of `Image.open(...).convert("RGB")` in
rlipv2_tpu/data/hico.py:100-108; the machine with the card has no PIL).

  * JPEG is decoded on the card by nvJPEG (`ops/csrc/jpeg_decode.cu`, built
    by `ops/cuda_build.py` and loaded with ctypes): one handle a decoder,
    one nvJPEG state and one side stream for each thread that decodes, and
    the decoded image copied back to the host, where the augmentations run.
    A grayscale file is repeated into RGB; a four-component (CMYK) file
    raises, naming the file. There is no host decoder: a JPEG read for the
    CPU, or where nvJPEG does not build, raises.
  * PNG is read by numpy and zlib: non-interlaced, 8 bits a sample, gray,
    RGB or RGBA (alpha dropped, as PIL's convert("RGB") drops it).
    `encode_png` writes one (filter 0), for files a run makes itself.

The format is taken from the file's magic bytes, not its name.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from pathlib import Path

import numpy as np
import torch

JPEG_MAGIC = b"\xff\xd8\xff"
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_SOURCE = "jpeg_decode.cu"
_NVJPEG_STATUS = {
    1: "not initialized", 2: "invalid parameter", 3: "bad JPEG", 4: "JPEG not supported",
    5: "allocator failure", 6: "execution failed", 7: "arch mismatch", 8: "internal error",
    9: "implementation not supported", 10: "incomplete bitstream",
}
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples a pixel


def _check(rc: int, what: str) -> None:
    if rc == 0:
        return
    if rc >= 1000:
        raise RuntimeError(f"{what}: CUDA error {rc - 1000}")
    raise RuntimeError(f"{what}: nvJPEG status {rc} ({_NVJPEG_STATUS.get(rc, 'unknown')})")


class NvJpegDecoder:
    """JPEG bytes -> (H, W, 3) uint8 host tensor through nvJPEG on `device`.
    Safe to call from several threads: each gets its own nvJPEG state and
    CUDA stream. `NvJpegDecoder.decodes` counts the decodes of every
    decoder in the process."""

    decodes = 0
    _count_lock = threading.Lock()

    def __init__(self, device="cuda"):
        from rlipv2_tpu_torch.ops.cuda_build import load_library

        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"nvJPEG decodes on a CUDA device, not {self.device}")
        lib = load_library(_SOURCE)
        vp, ci, pi = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
        lib.jpeg_create.argtypes = [ctypes.POINTER(vp)]
        lib.jpeg_destroy.argtypes = [vp]
        lib.jpeg_state_create.argtypes = [vp, ctypes.POINTER(vp)]
        lib.jpeg_state_destroy.argtypes = [vp]
        lib.jpeg_info.argtypes = [vp, ctypes.c_char_p, ctypes.c_size_t, pi, pi, pi, pi]
        lib.jpeg_decode.argtypes = [vp, vp, ctypes.c_char_p, ctypes.c_size_t, ci, vp, ci, vp]
        for fn in (lib.jpeg_create, lib.jpeg_destroy, lib.jpeg_state_create, lib.jpeg_state_destroy,
                   lib.jpeg_info, lib.jpeg_decode):
            fn.restype = ci
        self._lib = lib
        handle = vp()
        with torch.cuda.device(self.device):
            _check(lib.jpeg_create(ctypes.byref(handle)), "nvjpegCreateSimple")
        self._handle = handle
        self._local = threading.local()
        self._states: list = []
        self._lock = threading.Lock()

    def _thread_state(self):
        local = self._local
        if not hasattr(local, "state"):
            state = ctypes.c_void_p()
            _check(self._lib.jpeg_state_create(self._handle, ctypes.byref(state)), "nvjpegJpegStateCreate")
            with self._lock:
                self._states.append(state)
            local.state, local.stream = state, torch.cuda.Stream(self.device)
        return local.state, local.stream

    def info(self, data: bytes, name: str = "<bytes>") -> tuple[int, int, int]:
        """(components, height, width) from the file's header."""
        comps, ss, w, h = (ctypes.c_int() for _ in range(4))
        _check(self._lib.jpeg_info(self._handle, data, len(data), ctypes.byref(comps), ctypes.byref(ss),
                                   ctypes.byref(w), ctypes.byref(h)), f"{name}: nvjpegGetImageInfo")
        return comps.value, h.value, w.value

    def decode(self, data: bytes, name: str = "<bytes>") -> torch.Tensor:
        comps, h, w = self.info(data, name)
        if comps == 4:
            raise ValueError(f"{name}: a 4-component (CMYK/YCCK) JPEG is not supported")
        if comps not in (1, 3):
            raise ValueError(f"{name}: a {comps}-component JPEG is not supported")
        gray = comps == 1
        state, stream = self._thread_state()
        with torch.cuda.stream(stream):
            out = torch.empty((h, w) if gray else (h, w, 3), dtype=torch.uint8, device=self.device)
            _check(self._lib.jpeg_decode(self._handle, state, data, len(data), int(gray), out.data_ptr(),
                                         out.stride(0), stream.cuda_stream), f"{name}: nvjpegDecode")
            if gray:
                out = out[..., None].expand(h, w, 3).contiguous()
            host = out.cpu()  # waits for the side stream only
        with NvJpegDecoder._count_lock:
            NvJpegDecoder.decodes += 1
        return host

    def close(self) -> None:
        """Destroy every thread's state and the handle; the decoder is
        unusable afterwards."""
        with self._lock:
            states, self._states = self._states, []
        for state in states:
            _check(self._lib.jpeg_state_destroy(state), "nvjpegJpegStateDestroy")
        if self._handle is not None:
            _check(self._lib.jpeg_destroy(self._handle), "nvjpegDestroy")
            self._handle = None


class ImageReader:
    """`read(path)` -> (H, W, 3) uint8 RGB host tensor. JPEG goes through
    an `NvJpegDecoder` on `device`, made at the first JPEG; with a CPU
    device a JPEG raises."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self._jpeg = None
        self._lock = threading.Lock()

    def _decoder(self) -> NvJpegDecoder:
        with self._lock:
            if self._jpeg is None:
                self._jpeg = NvJpegDecoder(self.device)
            return self._jpeg

    def read(self, path) -> torch.Tensor:
        data = Path(path).read_bytes()
        if data.startswith(JPEG_MAGIC):
            if self.device.type != "cuda":
                raise RuntimeError(
                    f"{path}: JPEG decodes with nvJPEG on a CUDA device, and this reader's device is "
                    f"{self.device}; nothing decodes JPEG on the host"
                )
            return self._decoder().decode(data, str(path))
        if data.startswith(PNG_MAGIC):
            return torch.from_numpy(decode_png(data, str(path)))
        raise ValueError(f"{path}: neither JPEG nor PNG (first bytes {data[:8]!r})")

    def close(self) -> None:
        with self._lock:
            if self._jpeg is not None:
                self._jpeg.close()
                self._jpeg = None


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 RGB."""
    if not data.startswith(PNG_MAGIC):
        raise ValueError(f"{name}: not a PNG file")
    pos, header, idat = len(PNG_MAGIC), None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{name}: PNG without IHDR")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _PNG_CHANNELS or interlace != 0:
        raise ValueError(
            f"{name}: PNG with bit depth {depth}, colour type {colour}, interlace {interlace}; "
            "only non-interlaced 8-bit gray, RGB and RGBA are read"
        )
    ch = _PNG_CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = w * ch
    if raw.size != h * (stride + 1):
        raise ValueError(f"{name}: PNG data of {raw.size} bytes, expected {h * (stride + 1)}")
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        out[y] = prior = _unfilter(int(rows[y, 0]), rows[y, 1:], prior, ch, name)
    img = out.reshape(h, w, ch)
    if ch == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def _unfilter(kind: int, line: np.ndarray, prior: np.ndarray, bpp: int, name: str) -> np.ndarray:
    """One scanline's reconstruction (PNG specification, section 9)."""
    if kind == 0:
        return line.copy()
    if kind == 1:  # Sub: a running sum over each sample of a pixel, mod 256
        return np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
    if kind == 2:  # Up
        return line + prior
    if kind not in (3, 4):
        raise ValueError(f"{name}: PNG filter type {kind}")
    cur, up = bytearray(line.tobytes()), prior.tobytes()
    if kind == 3:  # Average
        for i in range(len(cur)):
            left = cur[i - bpp] if i >= bpp else 0
            cur[i] = (cur[i] + ((left + up[i]) >> 1)) & 0xFF
    else:  # Paeth
        for i in range(len(cur)):
            a = cur[i - bpp] if i >= bpp else 0
            b = up[i]
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            cur[i] = (cur[i] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3) or (H, W) uint8 -> PNG bytes (8-bit RGB or gray, no
    interlace, filter 0 on every row)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    colour = 2 if img.ndim == 3 else 0
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    return (PNG_MAGIC + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes())) + chunk(b"IEND", b""))
