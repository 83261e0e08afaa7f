"""Minimal self-contained NIfTI-1 reader/writer, pure Python and numpy (the
port's copy of ``conditioned_diffusion_models_uad_tpu/data/nifti.py``, without
its optional g++-built reader).

Reference volume IO: src/datamodules/create_dataset.py:252-258 `sitk_reader`
reads NIfTI as float32 and delivers an (x, y, z) array. The curvature-flow
smoothing the reference applies at read time lives in transforms.py.

Supports .nii and .nii.gz, the dtypes that occur in this domain
(uint8/int16/int32/float32/float64), scl_slope/scl_inter scaling, and pixdim
spacing. Data is returned in (x, y, z) index order (NIfTI stores x fastest)."""
from __future__ import annotations

import gzip
import os
import struct
from dataclasses import dataclass

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}
_CODES = {np.dtype(np.uint8): 2, np.dtype(np.int16): 4, np.dtype(np.int32): 8,
          np.dtype(np.float32): 16, np.dtype(np.float64): 64}


@dataclass
class NiftiHeader:
    shape: tuple
    spacing: tuple
    dtype: np.dtype


def _open(path):
    raw = open(path, "rb").read()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    return raw


def read_nifti(path: str, dtype=np.float32) -> tuple[np.ndarray, NiftiHeader]:
    """Read a NIfTI-1 file -> (volume[x, y, z(, t)], header)."""
    raw = _open(path)
    if len(raw) < 348:
        raise ValueError(f"{path}: truncated NIfTI header")
    sizeof_hdr = struct.unpack("<i", raw[0:4])[0]
    endian = "<"
    if sizeof_hdr != 348:
        sizeof_hdr = struct.unpack(">i", raw[0:4])[0]
        if sizeof_hdr != 348:
            raise ValueError(f"{path}: not a NIfTI-1 file")
        endian = ">"
    magic = raw[344:348]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

    dim = struct.unpack(endian + "8h", raw[40:56])
    ndim = dim[0]
    shape = tuple(int(d) for d in dim[1 : 1 + ndim])
    datatype = struct.unpack(endian + "h", raw[70:72])[0]
    pixdim = struct.unpack(endian + "8f", raw[76:108])
    vox_offset = int(struct.unpack(endian + "f", raw[108:112])[0])
    scl_slope = struct.unpack(endian + "f", raw[112:116])[0]
    scl_inter = struct.unpack(endian + "f", raw[116:120])[0]

    np_dtype = _DTYPES.get(datatype)
    if np_dtype is None:
        raise ValueError(f"{path}: unsupported NIfTI datatype code {datatype}")
    count = int(np.prod(shape))
    arr = np.frombuffer(
        raw, dtype=np.dtype(np_dtype).newbyteorder(endian), count=count,
        offset=vox_offset,
    )
    # NIfTI stores x fastest -> C-order reshape uses reversed dims, then
    # transpose back to (x, y, z, ...)
    arr = arr.reshape(shape[::-1]).transpose(range(len(shape))[::-1])
    arr = np.asarray(arr, dtype=dtype)
    # NIfTI scaling: slope==0 means "no scaling"; otherwise y = x*slope + inter
    # (inter applies even when slope == 1 — matches the native reader)
    if (
        np.isfinite(scl_slope)
        and np.isfinite(scl_inter)
        and scl_slope != 0.0
        and (scl_slope != 1.0 or scl_inter != 0.0)
    ):
        arr = arr * scl_slope + scl_inter
    hdr = NiftiHeader(
        shape=shape, spacing=tuple(float(p) for p in pixdim[1 : 1 + ndim]),
        dtype=np.dtype(np_dtype),
    )
    return arr, hdr


def read_nifti_raw(path: str):
    """Raw ingest read for the device-preprocess path: voxel payload in the
    file's NATIVE dtype and NATIVE memory order (C-contiguous, reversed dims —
    NIfTI stores x fastest), plus the scl scaling to apply downstream.

    The expensive per-volume host work of `read_nifti` (dtype conversion,
    scl scaling, and above all the strided x-fastest->xyz transpose copy,
    ~50 ms per flagship volume on a 1-core host) is deliberately NOT done
    here — the device preprocess path applies them on the card.

    -> (vol_rev [..., z, y, x], shape_xyz, slope, inter)
    """
    raw = _open(path)
    if len(raw) < 348:
        raise ValueError(f"{path}: truncated NIfTI header")
    sizeof_hdr = struct.unpack("<i", raw[0:4])[0]
    endian = "<"
    if sizeof_hdr != 348:
        if struct.unpack(">i", raw[0:4])[0] != 348:
            raise ValueError(f"{path}: not a NIfTI-1 file")
        endian = ">"
    dim = struct.unpack(endian + "8h", raw[40:56])
    shape = tuple(int(d) for d in dim[1 : 1 + dim[0]])
    datatype = struct.unpack(endian + "h", raw[70:72])[0]
    vox_offset = int(struct.unpack(endian + "f", raw[108:112])[0])
    slope = struct.unpack(endian + "f", raw[112:116])[0]
    inter = struct.unpack(endian + "f", raw[116:120])[0]
    np_dtype = _DTYPES.get(datatype)
    if np_dtype is None:
        raise ValueError(f"{path}: unsupported NIfTI datatype code {datatype}")
    count = int(np.prod(shape))
    arr = np.frombuffer(
        raw, dtype=np.dtype(np_dtype).newbyteorder(endian), count=count,
        offset=vox_offset,
    ).reshape(tuple(reversed(shape)))
    if endian == ">":
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    if not (np.isfinite(slope) and np.isfinite(inter)) or slope == 0.0:
        slope, inter = 1.0, 0.0
    return arr, shape, float(slope), float(inter)


def write_nifti(
    path: str, vol: np.ndarray, spacing=(1.0, 1.0, 1.0),
    slope: float = 1.0, inter: float = 0.0,
) -> None:
    """Write a volume (x, y, z) as NIfTI-1 (.nii or .nii.gz by extension).

    `vol` is the STORED payload; slope/inter are recorded in the header so
    readers produce vol*slope + inter (NIfTI-1 scl_slope/scl_inter)."""
    vol = np.asarray(vol)
    code = _CODES.get(vol.dtype)
    if code is None:
        vol = vol.astype(np.float32)
        code = 16
    ndim = vol.ndim
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    dim = [ndim] + list(vol.shape) + [1] * (7 - ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, vol.dtype.itemsize * 8)  # bitpix
    pd = [1.0] + list(spacing) + [1.0] * (7 - len(spacing))
    struct.pack_into("<8f", hdr, 76, *pd[:8])
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, float(slope))  # scl_slope
    struct.pack_into("<f", hdr, 116, float(inter))  # scl_inter
    # sform/qform: identity-ish, qform_code = sform_code = 0 (index space only)
    hdr[344:348] = b"n+1\x00"
    payload = bytes(hdr) + b"\x00" * 4 + np.ascontiguousarray(
        vol.transpose(range(ndim)[::-1])
    ).tobytes()
    if str(path).endswith(".gz"):
        with gzip.open(path, "wb", compresslevel=1) as f:
            f.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)
