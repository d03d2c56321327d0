"""Minimal NIfTI-1 reader and writer in numpy (gzip, struct; no nibabel).

A copy of ``diff_unet_tpu/data/nifti.py`` (that module cannot be imported
without jax): header parse, gzip support, scl_slope/scl_inter scaling,
sform/qform affine extraction, the writer with an sform affine, and the
reorientation to RAS+.

Layout note: NIfTI stores Fortran-order (i fastest); the reader returns
C-contiguous arrays indexed [i, j, k] with the matching affine mapping
voxel indices to world (scanner RAS+) millimetres.
"""
from __future__ import annotations

import dataclasses
import gzip
import struct
from pathlib import Path
from typing import Optional, Union

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
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclasses.dataclass
class NiftiImage:
    data: np.ndarray          # (i, j, k[, t...])
    affine: np.ndarray        # 4x4 voxel->world (RAS+ mm)

    @property
    def spacing(self) -> np.ndarray:
        """Voxel spacing along each spatial axis (mm)."""
        return np.linalg.norm(self.affine[:3, :3], axis=0)


def _quaternion_affine(hdr) -> np.ndarray:
    b, c, d = hdr["quatern_b"], hdr["quatern_c"], hdr["quatern_d"]
    a = np.sqrt(max(0.0, 1.0 - (b * b + c * c + d * d)))
    r = np.array([
        [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
        [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
        [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
    ])
    qfac = hdr["pixdim"][0] if hdr["pixdim"][0] != 0 else 1.0
    spacing = np.array([hdr["pixdim"][1], hdr["pixdim"][2],
                        hdr["pixdim"][3] * qfac])
    aff = np.eye(4)
    aff[:3, :3] = r * spacing
    aff[:3, 3] = [hdr["qoffset_x"], hdr["qoffset_y"], hdr["qoffset_z"]]
    return aff


def _parse_header(raw: bytes) -> dict:
    if len(raw) < 348:
        raise ValueError("truncated NIfTI header")
    sizeof_hdr = struct.unpack_from("<i", raw, 0)[0]
    endian = "<"
    if sizeof_hdr != 348:
        sizeof_hdr = struct.unpack_from(">i", raw, 0)[0]
        if sizeof_hdr != 348:
            raise ValueError("not a NIfTI-1 file")
        endian = ">"

    def u(fmt, off):
        return struct.unpack_from(endian + fmt, raw, off)

    hdr = {
        "endian": endian,
        "dim": u("8h", 40),
        "datatype": u("h", 70)[0],
        "bitpix": u("h", 72)[0],
        "pixdim": u("8f", 76),
        "vox_offset": u("f", 108)[0],
        "scl_slope": u("f", 112)[0],
        "scl_inter": u("f", 116)[0],
        "qform_code": u("h", 252)[0],
        "sform_code": u("h", 254)[0],
        "quatern_b": u("f", 256)[0],
        "quatern_c": u("f", 260)[0],
        "quatern_d": u("f", 264)[0],
        "qoffset_x": u("f", 268)[0],
        "qoffset_y": u("f", 272)[0],
        "qoffset_z": u("f", 276)[0],
        "srow_x": u("4f", 280),
        "srow_y": u("4f", 296),
        "srow_z": u("4f", 312),
        "magic": raw[344:348],
    }
    if hdr["magic"][:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"bad NIfTI magic: {hdr['magic']!r}")
    return hdr


def read_nifti(path: Union[str, Path], *, dtype=None,
               apply_scaling: bool = True) -> NiftiImage:
    path = Path(path)
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        raw = f.read()

    hdr = _parse_header(raw[:348])
    ndim = hdr["dim"][0]
    shape = tuple(hdr["dim"][1:1 + ndim])
    np_dtype = _DTYPES.get(hdr["datatype"])
    if np_dtype is None:
        raise NotImplementedError(f"NIfTI datatype {hdr['datatype']}")

    offset = int(hdr["vox_offset"])
    count = int(np.prod(shape))
    data = np.frombuffer(
        raw, dtype=np.dtype(np_dtype).newbyteorder(hdr["endian"]),
        count=count, offset=offset,
    )
    # NIfTI is Fortran-ordered on disk
    data = data.reshape(shape[::-1]).transpose(range(ndim)[::-1])

    slope, inter = hdr["scl_slope"], hdr["scl_inter"]
    if apply_scaling and slope != 0.0 and (slope != 1.0 or inter != 0.0):
        data = data.astype(np.float32) * slope + inter
    if dtype is not None:
        data = data.astype(dtype)
    else:
        data = _blocked_copy(data)   # Fortran->C copy, cache-tiled

    if hdr["sform_code"] > 0:
        affine = np.eye(4)
        affine[0] = hdr["srow_x"]
        affine[1] = hdr["srow_y"]
        affine[2] = hdr["srow_z"]
    elif hdr["qform_code"] > 0:
        affine = _quaternion_affine(hdr)
    else:
        affine = np.diag(list(hdr["pixdim"][1:4]) + [1.0])
    return NiftiImage(data=data, affine=affine)


def write_nifti(path: Union[str, Path], data: np.ndarray,
                affine: Optional[np.ndarray] = None, *,
                compresslevel: int = 1) -> None:
    """Write a NIfTI-1 (.nii / .nii.gz) volume with an sform affine.

    compresslevel=1 by default: the gzip module's default (9) costs ~5 s
    on a CT-sized volume for a few percent of size (measured), which would
    dominate the serving write path; segmentation labelmaps are mostly
    zeros and compress well at any level.
    """
    path = Path(path)
    data = np.asarray(data)
    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    if np.dtype(data.dtype) not in _DTYPE_CODES:
        data = data.astype(np.float32)
    affine = np.eye(4) if affine is None else np.asarray(affine, np.float64)

    hdr = bytearray(352)  # 348 header + 4-byte extension flag
    struct.pack_into("<i", hdr, 0, 348)
    dims = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<h", hdr, 70, _DTYPE_CODES[np.dtype(data.dtype)])
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)
    spacing = np.linalg.norm(affine[:3, :3], axis=0)
    pixdim = [1.0] + list(spacing) + [1.0] * (7 - 3)
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)   # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)     # scl_slope
    struct.pack_into("<h", hdr, 254, 1)       # sform_code
    struct.pack_into("<4f", hdr, 280, *affine[0])
    struct.pack_into("<4f", hdr, 296, *affine[1])
    struct.pack_into("<4f", hdr, 312, *affine[2])
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + np.asfortranarray(data).tobytes(order="F")
    if path.suffix == ".gz":
        with gzip.open(path, "wb", compresslevel=compresslevel) as f:
            f.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)


def _blocked_copy(view: np.ndarray, bs: int = 32) -> np.ndarray:
    """Contiguous copy of a strided (transposed/flipped) view, tiled over
    the two outer axes. A naive `ascontiguousarray` of an axis-reversed CT
    volume walks the source with a ~1 MB stride and runs at ~50 MB/s;
     32-voxel tiles keep both source and destination lines cache-resident
    (~2x faster, measured on (512,512,100) int16)."""
    if view.flags.c_contiguous:
        return view
    out = np.empty(view.shape, view.dtype)
    if view.ndim < 2 or view.size * view.itemsize < (1 << 22):
        out[...] = view
        return out
    for i in range(0, view.shape[0], bs):
        for j in range(0, view.shape[1], bs):
            out[i:i + bs, j:j + bs] = view[i:i + bs, j:j + bs]
    return out


_AXCODES = {0: ("L", "R"), 1: ("P", "A"), 2: ("I", "S")}


def orientation_codes(affine: np.ndarray) -> tuple:
    """Axis codes of each data axis (nibabel aff2axcodes equivalent)."""
    r = affine[:3, :3]
    codes = []
    used = set()
    for col in range(3):
        v = r[:, col]
        order = np.argsort(-np.abs(v))
        for world in order:
            if world not in used:
                break
        used.add(world)
        neg, pos = _AXCODES[int(world)]
        codes.append(pos if v[world] >= 0 else neg)
    return tuple(codes)


def to_ras(img: NiftiImage) -> NiftiImage:
    """Reorient data + affine to RAS+ (MONAI Orientationd(axcodes="RAS"))."""
    r = img.affine[:3, :3]
    # assign each data axis to its dominant world axis
    perm = [-1, -1, -1]   # perm[world] = data axis
    used = set()
    for col in np.argsort(
        -np.max(np.abs(r), axis=0)
    ):  # most decisive columns first
        order = np.argsort(-np.abs(r[:, col]))
        for world in order:
            if world not in used:
                perm[int(world)] = int(col)
                used.add(int(world))
                break
    data = np.transpose(img.data, perm)
    affine = img.affine.copy()
    affine[:3, :3] = img.affine[:3, :3][:, perm]

    flips = [slice(None)] * 3
    for world in range(3):
        if affine[world, world] < 0:
            flips[world] = slice(None, None, -1)
            affine[:3, 3] += affine[:3, world] * (data.shape[world] - 1)
            affine[:3, world] *= -1
    data = _blocked_copy(data[tuple(flips)])
    return NiftiImage(data=data, affine=affine)
