"""TFRecord file I/O: a native C++ reader with a pure-Python fallback.

File framing (identical to TF's): for each record
    uint64  length           (little-endian)
    uint32  masked crc32c of the length bytes
    bytes   data[length]
    uint32  masked crc32c of data
masked(crc) = ((crc >> 15) | (crc << 17)) + 0xa282ead8  (mod 2^32)

The port's counterpart of the JAX package's `data/tfrecord.py`, with the
same reader, writer and shard naming. The native reader is the port's own
copy of the C++ source, `native/tfrecord_io.cpp`: at first use the host
C++ compiler builds it into the package's `_build/` directory (listed in
`.gitignore`) under a name that hashes the source and the flags, so an
edited source is rebuilt and a finished build is reused. It mmaps a file,
walks its framing and checks every CRC32C (SSE4.2 on x86-64) once, and
hands out zero-copy pointers into the mapping; the writer takes its
CRC32C from the same library. A host with no C++ compiler reads with the
pure-Python reader below, which checks the same CRCs at a few ms per
30 KB record. `native_available()` says which reader
is in use. Both readers always check the CRCs.

Shard naming follows the reference convention
``file_{split}_%02i-%i.tfrec`` where the trailing integer is the example
count, which the dataset length accounting parses instead of counting
records (dataset_builder.py:304-310).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import struct
import subprocess
import threading
import warnings
from pathlib import Path
from typing import Iterator, List, Optional, Sequence

_SOURCE = Path(__file__).resolve().parents[1] / "native" / "tfrecord_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ["-O3", "-Wall", "-shared", "-fPIC", "-std=c++17"]

# ---------------------------------------------------------------------------
# crc32c (Castagnoli), table-driven
# ---------------------------------------------------------------------------

_CRC_TABLE: Optional[List[int]] = None


def _crc_table() -> List[int]:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78  # reflected Castagnoli polynomial
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    """CRC32C of `data`: in the native library when it is built, else in
    Python."""
    lib = _load_native()
    if lib is not None:
        return int(lib.tfrec_crc32c(data, len(data)))
    return _crc32c_python(data)


def _crc32c_python(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _mask(crc: int) -> int:
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    return _mask(crc32c(data))


# ---------------------------------------------------------------------------
# The native reader: built at first use, loaded with ctypes
# ---------------------------------------------------------------------------

_native: Optional[ctypes.CDLL] = None
_native_tried = False
_lock = threading.Lock()


def _flags() -> List[str]:
    # Every x86-64 CPU since 2008 has the SSE4.2 CRC32 instruction.
    sse = ["-msse4.2"] if platform.machine() in ("x86_64", "AMD64") else []
    return CXX_FLAGS + sse


def library_path() -> Path:
    h = hashlib.sha256(" ".join(_flags()).encode())
    h.update(_SOURCE.read_bytes())
    return BUILD_DIR / f"libspe_tfrecord_{h.hexdigest()[:16]}.so"


def build() -> Optional[Path]:
    """Compile the native reader unless a library for this source exists.
    Returns its path, or None (with a warning) when the host has no C++
    compiler or the compile fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *_flags(), "-o", str(tmp), str(_SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        warnings.warn(f"native TFRecord reader did not build, reading with "
                      f"the pure-Python reader:\n{' '.join(cmd)}\n"
                      f"{res.stderr}")
        return None
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def _load_native() -> Optional[ctypes.CDLL]:
    global _native, _native_tried
    with _lock:
        if not _native_tried:
            _native_tried = True
            path = build()
            if path is not None:
                lib = ctypes.CDLL(str(path))
                lib.tfrec_open.argtypes = [ctypes.c_char_p]
                lib.tfrec_open.restype = ctypes.c_void_p
                lib.tfrec_close.argtypes = [ctypes.c_void_p]
                lib.tfrec_close.restype = None
                lib.tfrec_num_records.argtypes = [ctypes.c_void_p]
                lib.tfrec_num_records.restype = ctypes.c_int64
                lib.tfrec_record_ptr.argtypes = [
                    ctypes.c_void_p, ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_int64)]
                lib.tfrec_record_ptr.restype = ctypes.c_void_p
                lib.tfrec_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_int64]
                lib.tfrec_crc32c.restype = ctypes.c_uint32
                _native = lib
        return _native


def native_available() -> bool:
    """True when records are read by the native reader."""
    return _load_native() is not None


# ---------------------------------------------------------------------------
# Reader / Writer
# ---------------------------------------------------------------------------

class TFRecordWriter:
    """Write records in TFRecord framing. Context-manager friendly."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "wb")

    def write(self, record: bytes) -> None:
        length = struct.pack("<Q", len(record))
        self._f.write(length)
        self._f.write(struct.pack("<I", masked_crc32c(length)))
        self._f.write(record)
        self._f.write(struct.pack("<I", masked_crc32c(record)))

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _iter_records_python(path: str) -> Iterator[bytes]:
    """The pure-Python reader: framing and CRCs in Python alone."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                return
            if len(header) < 12:
                raise IOError(f"truncated record header in {path}")
            (length,) = struct.unpack("<Q", header[:8])
            (crc,) = struct.unpack("<I", header[8:12])
            if _mask(_crc32c_python(header[:8])) != crc:
                raise IOError(f"length CRC mismatch in {path}")
            # Bounds-check the untrusted length BEFORE read(): a hostile
            # length near 2^64 (its CRC is computable by anyone) would
            # otherwise overflow read()'s index argument.
            if length > size - f.tell():
                raise IOError(f"truncated record in {path}")
            data = f.read(length)
            footer = f.read(4)
            if len(data) < length or len(footer) < 4:
                raise IOError(f"truncated record in {path}")
            (crc,) = struct.unpack("<I", footer)
            if _mask(_crc32c_python(data)) != crc:
                raise IOError(f"data CRC mismatch in {path}")
            yield data


class TFRecordReader:
    """Random-access reader over one TFRecord file.

    With the native library the file is mmap'd and indexed once in C++,
    every CRC checked there, and records are copied out of the mapping on
    access. Without it the pure-Python reader scans the framing.
    """

    def __init__(self, path: str):
        self.path = path
        self._records: Optional[List[bytes]] = None
        self._handle = None
        lib = _load_native()
        if lib is not None:
            self._lib = lib
            self._handle = lib.tfrec_open(path.encode())
            if not self._handle:
                raise IOError(f"cannot open/index {path} (missing, "
                              f"truncated or CRC mismatch)")
        else:
            self._records = list(_iter_records_python(path))

    def __len__(self) -> int:
        if self._handle:
            return int(self._lib.tfrec_num_records(self._handle))
        return len(self._records)

    def __getitem__(self, i: int) -> bytes:
        if self._handle:
            n = ctypes.c_int64()
            ptr = self._lib.tfrec_record_ptr(self._handle, i, ctypes.byref(n))
            if not ptr:
                raise IndexError(i)
            return ctypes.string_at(ptr, n.value)
        return self._records[i]

    def __iter__(self) -> Iterator[bytes]:
        for i in range(len(self)):
            yield self[i]

    def close(self) -> None:
        if self._handle:
            self._lib.tfrec_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


def iter_records(path: str) -> Iterator[bytes]:
    """Stream records from one file (native-indexed when available)."""
    if _load_native() is not None:
        with TFRecordReader(path) as reader:
            yield from reader
    else:
        yield from _iter_records_python(path)


# ---------------------------------------------------------------------------
# Shard naming (reference convention)
# ---------------------------------------------------------------------------

def shard_filename(split_dir: str, shard_index: int, num_examples: int) -> str:
    """``file_{split}_%02i-%i.tfrec`` (gen_tfrecords.py:108-110)."""
    split = os.path.basename(os.path.normpath(split_dir))
    return os.path.join(split_dir,
                        "file_%s_%.2i-%i.tfrec" % (split, shard_index, num_examples))


def count_examples_from_filenames(filenames: Sequence[str]) -> int:
    """Dataset length from shard-name suffixes (dataset_builder.py:304-310)."""
    total = 0
    for name in filenames:
        stem = os.path.basename(name).rsplit(".", 1)[0]
        total += int(stem.split("-")[-1])
    return total
