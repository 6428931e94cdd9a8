"""RecordIO: counterpart of ``mxnet_tpu/io/recordio.py`` (dmlc-core
recordio and ``python/mxnet/recordio.py``), in plain Python.

Binary-compatible with the dmlc RecordIO on-disk format: each record is
``[kMagic u32][lrec u32][payload][pad to 4B]`` where lrec encodes
``cflag`` (top 3 bits, for multi-chunk records) and length (lower 29).
``IRHeader`` packing matches ``python/mxnet/recordio.py``, so ``.rec``
image packs that either package (or the reference's ``tools/im2rec.py``)
writes load unchanged, byte for byte.

``pack_img`` encodes JPEG with cv2 or PIL, in the JAX package's order; a
host with neither raises for a JPEG request (``img_fmt=".npy"`` or a
non-RGB image packs lossless npy bytes, as in the JAX package).
``unpack_img`` decodes JPEG through the shared C++ decoder
(``mxnet_tpu_torch.native``).
"""
from __future__ import annotations

import struct
from collections import namedtuple

import numpy as np

from ..base import MXNetError

__all__ = ["MXRecordIO", "IndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_KMAGIC = 0xCED7230A

IRHeader = namedtuple("IRHeader", ["flag", "label", "id", "id2"])


class MXRecordIO:
    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.open()

    def open(self):
        if self.flag == "w":
            self._f = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self._f = open(self.uri, "rb")
            self.writable = False
        else:
            raise MXNetError(f"invalid flag {self.flag}")

    def close(self):
        self._f.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def reset(self):
        self._f.seek(0)

    def tell(self):
        return self._f.tell()

    def write(self, buf: bytes):
        assert self.writable
        lrec = len(buf)  # single-chunk record: cflag=0
        self._f.write(struct.pack("<II", _KMAGIC, lrec))
        self._f.write(buf)
        pad = (-len(buf)) % 4
        if pad:
            self._f.write(b"\x00" * pad)

    def read(self):
        assert not self.writable
        hdr = self._f.read(8)
        if len(hdr) < 8:
            return None
        magic, lrec = struct.unpack("<II", hdr)
        if magic != _KMAGIC:
            raise MXNetError("corrupt RecordIO: bad magic")
        cflag = lrec >> 29
        length = lrec & ((1 << 29) - 1)
        buf = self._f.read(length)
        self._f.read((-length) % 4)
        if cflag != 0:
            # multi-chunk record: keep reading continuation chunks
            parts = [buf]
            while cflag in (1, 2):
                magic, lrec = struct.unpack("<II", self._f.read(8))
                cflag = lrec >> 29
                length = lrec & ((1 << 29) - 1)
                parts.append(self._f.read(length))
                self._f.read((-length) % 4)
                if cflag == 3:
                    break
            buf = b"".join(parts)
        return buf


class IndexedRecordIO(MXRecordIO):
    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)
        if flag == "r":
            with open(idx_path) as f:
                for line in f:
                    k, v = line.strip().split("\t")
                    k = key_type(k)
                    self.idx[k] = int(v)
                    self.keys.append(k)

    def close(self):
        super().close()
        if self.writable and self.idx:
            with open(self.idx_path, "w") as f:
                for k in self.keys:
                    f.write(f"{k}\t{self.idx[k]}\n")
            self.idx = {}

    def read_idx(self, idx):
        self._f.seek(self.idx[idx])
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.idx[key] = pos
        self.keys.append(key)


def pack(header: IRHeader, s: bytes) -> bytes:
    header = IRHeader(*header)
    if isinstance(header.label, (int, float)):
        hdr = struct.pack("<IfQQ", 0, float(header.label), header.id, header.id2)
    else:
        label = np.asarray(header.label, dtype=np.float32)
        hdr = struct.pack("<IfQQ", label.size, 0.0, header.id, header.id2) + label.tobytes()
    return hdr + s


def unpack(s: bytes):
    flag, label, id_, id2 = struct.unpack("<IfQQ", s[:24])
    s = s[24:]
    if flag > 0:
        label = np.frombuffer(s[:flag * 4], dtype=np.float32)
        s = s[flag * 4:]
    return IRHeader(flag, label, id_, id2), s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Pack a HWC uint8 image: JPEG (via cv2 or PIL, as the reference's
    cv2.imencode) for an RGB image and ``img_fmt`` ".jpg"/".jpeg", else
    lossless npy bytes. Readers (``unpack_img``, ``ImageRecordIter``) tell
    the formats apart by their magic bytes. A JPEG request on a host with
    neither encoder raises."""
    import io as _io

    img = np.asarray(img, dtype=np.uint8)
    if img_fmt in (".jpg", ".jpeg") and img.ndim == 3 and img.shape[2] == 3:
        try:
            import cv2
        except ImportError:
            cv2 = None
        if cv2 is not None:
            ok, enc = cv2.imencode(".jpg", cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                                   [cv2.IMWRITE_JPEG_QUALITY, int(quality)])
            if not ok:
                raise MXNetError("cv2.imencode failed")
            return pack(header, enc.tobytes())
        try:
            import PIL.Image
        except ImportError:
            raise MXNetError("pack_img: JPEG needs cv2 or PIL, and neither "
                             "is installed; pass img_fmt='.npy' for "
                             "lossless npy payloads") from None
        buf = _io.BytesIO()
        PIL.Image.fromarray(img).save(buf, "JPEG", quality=int(quality))
        return pack(header, buf.getvalue())
    buf = _io.BytesIO()
    np.save(buf, img)
    return pack(header, buf.getvalue())


def unpack_img(s, iscolor=-1):
    header, img_bytes = unpack(s)
    import io as _io

    if img_bytes[:6] == b"\x93NUMPY":
        img = np.load(_io.BytesIO(img_bytes))
    elif img_bytes[:2] == b"\xff\xd8":
        # JPEG: the shared C++ decoder (native/src/jpeg.cc)
        from ..native import jpeg_decode

        img = jpeg_decode(bytes(img_bytes))
    else:
        try:
            import PIL.Image

            img = np.asarray(PIL.Image.open(_io.BytesIO(img_bytes)))
        except Exception as e:
            raise MXNetError("cannot decode image payload (not JPEG/npy and "
                             "no PIL available)") from e
    return header, img
