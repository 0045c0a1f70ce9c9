"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles every source into one shared library with a plain C
interface, once, at first use, into ``starframe_tpu_torch/_build/``: one
``nvcc`` per source, all started together, then one link. The file name
carries a hash of the sources and flags, so an edited kernel is rebuilt and
a stale library is never loaded; the compiler's per-kernel register and
shared-memory report (``-Xptxas -v``) is kept beside it (:func:`build_log`).
The library is bound with
``ctypes``: each entry point takes a pointer to an argument struct (mirrored
below as a ``ctypes.Structure``) and the CUDA stream, launches on that
stream and returns ``cudaGetLastError()``.

``-fmad=false`` keeps the compiler from contracting ``a * b + c`` into one
fused multiply-add. The plain PyTorch twins and the JAX reference round
every product and sum separately; without the flag the kernels would differ
from both in the last bits, and the frame kernel's contact thresholds
(``c < 0``, ``lam_n > 0``) would amplify that into different ``touched``
tables. No ``--use_fast_math``: ``sqrtf``, division, ``cosf`` and ``sinf``
stay IEEE-accurate for the same reason.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v"]

_lib = None
build_seconds = None  # wall time of this process's build (None: loaded)


# the joint-parameter arrays of the frame kernel, in its argument order
JOINT_KEYS = ("jtype", "jba", "jbb", "jaax", "jaay", "jabx", "jaby", "jrest",
              "jlo", "jhi", "jcomp", "jdamp", "jms", "jmm", "jcolor")


class EligArgs(ctypes.Structure):
    _fields_ = [
        ("cbody", ctypes.c_void_p), ("layer", ctypes.c_void_p),
        ("lmask", ctypes.c_void_p), ("active", ctypes.c_void_p),
        ("sensor", ctypes.c_void_p), ("responds", ctypes.c_void_p),
        ("moves", ctypes.c_void_p), ("elig", ctypes.c_void_p),
        ("W", ctypes.c_int), ("N", ctypes.c_int), ("M", ctypes.c_int),
    ]


class SlotArgs(ctypes.Structure):
    _fields_ = [
        ("posx", ctypes.c_void_p), ("posy", ctypes.c_void_p),
        ("ang", ctypes.c_void_p), ("velx", ctypes.c_void_p),
        ("vely", ctypes.c_void_p), ("cbody", ctypes.c_void_p),
        ("vlx", ctypes.c_void_p), ("vly", ctypes.c_void_p),
        ("radius", ctypes.c_void_p), ("elig", ctypes.c_void_p),
        ("partner", ctypes.c_void_p), ("slot_act", ctypes.c_void_p),
        ("count", ctypes.c_void_p), ("count_touch", ctypes.c_void_p),
        ("count_close", ctypes.c_void_p), ("budget", ctypes.c_void_p),
        ("W", ctypes.c_int), ("N", ctypes.c_int), ("M", ctypes.c_int),
        ("V", ctypes.c_int), ("C", ctypes.c_int),
        ("partner_aware", ctypes.c_int),
        ("dt", ctypes.c_float), ("tpad", ctypes.c_float),
        ("cpad", ctypes.c_float),
    ]


class Frame2Args(ctypes.Structure):
    _fields_ = [
        ("posx", ctypes.c_void_p), ("posy", ctypes.c_void_p),
        ("ang", ctypes.c_void_p), ("velx", ctypes.c_void_p),
        ("vely", ctypes.c_void_p), ("angvel", ctypes.c_void_p),
        ("invm", ctypes.c_void_p), ("invi", ctypes.c_void_p),
        ("dyn", ctypes.c_void_p), ("kin", ctypes.c_void_p),
        ("cbody", ctypes.c_void_p), ("vlx", ctypes.c_void_p),
        ("vly", ctypes.c_void_p), ("nverts", ctypes.c_void_p),
        ("radius", ctypes.c_void_p), ("fric", ctypes.c_void_p),
        ("rest", ctypes.c_void_p), ("sensor", ctypes.c_void_p),
        ("partner", ctypes.c_void_p), ("slot_act", ctypes.c_void_p),
        ("gravity", ctypes.c_void_p), ("owner_start", ctypes.c_void_p),
        ("owner_idx", ctypes.c_void_p), ("gtab", ctypes.c_void_p),
        ("o_posx", ctypes.c_void_p), ("o_posy", ctypes.c_void_p),
        ("o_ang", ctypes.c_void_p), ("o_velx", ctypes.c_void_p),
        ("o_vely", ctypes.c_void_p), ("o_angvel", ctypes.c_void_p),
        ("o_touched", ctypes.c_void_p),
        ("W", ctypes.c_int), ("N", ctypes.c_int), ("M", ctypes.c_int),
        ("V", ctypes.c_int), ("C", ctypes.c_int),
        ("substeps", ctypes.c_int), ("iterations", ctypes.c_int),
        ("h", ctypes.c_float), ("dt", ctypes.c_float),
        ("margin", ctypes.c_float), ("alpha_t", ctypes.c_float),
        ("relaxation", ctypes.c_float), ("max_dpos", ctypes.c_float),
        ("rest_threshold", ctypes.c_float), ("lin_sdamp", ctypes.c_float),
        ("ang_sdamp", ctypes.c_float), ("use_lin_damp", ctypes.c_int),
        ("use_ang_damp", ctypes.c_int),
        *((k, ctypes.c_void_p) for k in JOINT_KEYS),
        ("jslot", ctypes.c_void_p), ("jside", ctypes.c_void_p),
        ("jact", ctypes.c_void_p),
        ("J", ctypes.c_int), ("JC", ctypes.c_int),
        ("joint_colored", ctypes.c_int), ("n_colors", ctypes.c_int),
        ("max_dpos_joint", ctypes.c_float), ("hh", ctypes.c_float),
        ("bullet", ctypes.c_void_p), ("side", ctypes.c_void_p),
        ("ccd", ctypes.c_int), ("ccd_slop", ctypes.c_float),
        ("owner_per_world", ctypes.c_int), ("Cs", ctypes.c_int),
        ("o_partner", ctypes.c_void_p), ("o_nact", ctypes.c_void_p),
        ("gscratch", ctypes.c_void_p), ("live_items", ctypes.c_void_p),
        ("slot_rows", ctypes.c_void_p), ("Rs", ctypes.c_int),
    ]


class JointSlotArgs(ctypes.Structure):
    _fields_ = [
        ("jba", ctypes.c_void_p), ("jbb", ctypes.c_void_p),
        ("jactive", ctypes.c_void_p), ("jslot", ctypes.c_void_p),
        ("jside", ctypes.c_void_p), ("jact", ctypes.c_void_p),
        ("count", ctypes.c_void_p),
        ("W", ctypes.c_int), ("N", ctypes.c_int), ("J", ctypes.c_int),
        ("JC", ctypes.c_int),
    ]


def _struct(name: str, pointers: str, ints: str = "", floats: str = ""):
    """A ctypes mirror of a C argument struct: the named pointers, then
    the ints, then the floats, in that order."""
    fields = ([(k, ctypes.c_void_p) for k in pointers.split()]
              + [(k, ctypes.c_int) for k in ints.split()]
              + [(k, ctypes.c_float) for k in floats.split()])
    return type(name, (ctypes.Structure,), {"_fields_": fields})


TileTablesArgs = _struct(
    "TileTablesArgs",
    "px py an vx vy vlx vly rad act mov lay msk obody responds sen l_px l_py "
    "l_an l_vlx l_vly l_rad l_act l_lay l_msk edge_lo edge_hi gravity pidx "
    "act_o count count_touch count_close winover sweep",
    "Nt V C sort_axis sweep_frames",
    "dt kdt tpad cpad sweep_slack sweep_floor sweep_cap")


class TileManifoldArgs(ctypes.Structure):
    _fields_ = [
        *((k, ctypes.c_void_p) for k in (
            "px py an vx vy om vlx vly rad nv fric rst sen invm invi l_px "
            "l_py l_an l_vlx l_vly l_rad l_nv l_fric l_rst l_sen pidx act "
            "tile_live sol pidx_c src nact wake pen npts cid lcid keyc kin"
        ).split()),
        ("Nt", ctypes.c_int), ("V", ctypes.c_int), ("C", ctypes.c_int),
        ("Cs", ctypes.c_int), ("margin", ctypes.c_float),
        ("dt", ctypes.c_float), ("sleep_v2", ctypes.c_float),
        ("use_wake", ctypes.c_int), ("n_colliders", ctypes.c_int),
        ("kin_v2", ctypes.c_float),
    ]


TileProjectArgs = _struct(
    "TileProjectArgs",
    "px py an vx vy om invm invi dynb l_px l_py l_an pidx_c sol gravity "
    "touched_in tile_live dxx dxy dth cnt lam touched f",
    "Nt Cs", "h alpha_t")


class TileApplyArgs(ctypes.Structure):
    _fields_ = [
        *((k, ctypes.c_void_p) for k in (
            "px py an vx vy om dxx dxy dth cnt invm invi dynb kin l_px l_py "
            "l_an pidx_c sol lam gravity tile_live o_px o_py o_an o_vx o_vy "
            "o_om accv f").split()),
        ("Nt", ctypes.c_int), ("Cs", ctypes.c_int),
        *((k, ctypes.c_float) for k in (
            "h relaxation max_dpos rest_threshold lin_sdamp "
            "ang_sdamp").split()),
        ("use_lin_damp", ctypes.c_int), ("use_ang_damp", ctypes.c_int),
    ]


TileCcdArgs = _struct(
    "TileCcdArgs",
    "px py an vx vy om dynb blt l_px l_py l_an pidx_c sol gravity tile_live f",
    "Nt Cs", "h ccd_slop")


class TileFrameArgs(ctypes.Structure):
    _fields_ = [("project", TileProjectArgs), ("apply", TileApplyArgs),
                ("st_a", ctypes.c_void_p * 6), ("st_b", ctypes.c_void_p * 6),
                ("substeps", ctypes.c_int), ("ccd", TileCcdArgs)]


class TileCompoundFrameArgs(ctypes.Structure):
    _fields_ = [("frame", TileFrameArgs), ("osum", ctypes.c_void_p),
                ("f_own", ctypes.c_void_p), ("ob", ctypes.c_void_p),
                ("kc", ctypes.c_int)]


class OwnerSumArgs(ctypes.Structure):
    _fields_ = [("x", ctypes.c_void_p * 4), ("y", ctypes.c_void_p * 4),
                ("ob", ctypes.c_void_p), ("k", ctypes.c_int),
                ("n", ctypes.c_int), ("kc", ctypes.c_int)]


class OwnerVelocityArgs(ctypes.Structure):
    _fields_ = [
        *((k, ctypes.c_void_p) for k in
          "vx vy om accv ob o_vx o_vy o_om".split()),
        ("n", ctypes.c_int), ("kc", ctypes.c_int),
        ("lin_sdamp", ctypes.c_float), ("ang_sdamp", ctypes.c_float),
        ("use_lin_damp", ctypes.c_int), ("use_ang_damp", ctypes.c_int),
    ]


_ENTRY_POINTS = {"sf_elig": EligArgs, "sf_slots": SlotArgs,
                 "sf_joint_slots": JointSlotArgs, "sf_frame2": Frame2Args,
                 "sf_tile_tables": TileTablesArgs,
                 "sf_tile_manifold": TileManifoldArgs,
                 "sf_tile_project": TileProjectArgs,
                 "sf_tile_apply": TileApplyArgs,
                 "sf_tile_frame": TileFrameArgs,
                 "sf_tile_compound_frame": TileCompoundFrameArgs,
                 "sf_tile_ccd": TileCcdArgs,
                 "sf_owner_sum": OwnerSumArgs,
                 "sf_owner_min": OwnerSumArgs,
                 "sf_owner_velocity": OwnerVelocityArgs}


def _sources():
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libsf_kernels_{digest.hexdigest()[:16]}.so"


def build_log() -> str:
    """What nvcc and ptxas said when this checkout's library was built."""
    log = _library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _build(so: Path) -> None:
    """Compile every ``csrc/*.cu`` in parallel, then link ``so``."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in (s for s in _sources() if s.suffix == ".cu"):
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o",
                   str(Path(tmp) / (src.stem + ".o")), str(src)]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        # wait for every compiler before reporting any failure, so none
        # outlives this call
        log = [f"$ {' '.join(cmd)}\n{proc.communicate()[0]}"
               for cmd, proc in jobs]
        for (_, proc), text in zip(jobs, log):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   + text)
        objs = [cmd[cmd.index("-o") + 1] for cmd, _ in jobs]
        part = Path(tmp) / so.name
        cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(part), *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        so.with_suffix(".log").write_text("\n".join(log))
        os.replace(part, so)  # atomic: concurrent builders never see half a file


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call in this checkout."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    so = _library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        _build(so)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    for name, struct in _ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(struct), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        size = getattr(lib, name + "_args_size")
        size.argtypes = []
        size.restype = ctypes.c_int
        if size() != ctypes.sizeof(struct):
            raise RuntimeError(f"{name}: the C argument struct is "
                               f"{size()} bytes, its ctypes mirror "
                               f"{ctypes.sizeof(struct)}")
    for name in ("sf_frame2_shared_bytes", "sf_frame2_scratch_bytes"):
        getattr(lib, name).argtypes = [ctypes.c_int] * 6
        getattr(lib, name).restype = ctypes.c_longlong
    for name in ("sf_frame2_table_rows", "sf_frame2_table_size",
                 "sf_frame2_joints_shared", "sf_frame2_block_threads"):
        getattr(lib, name).argtypes = [ctypes.c_int] * 6
        getattr(lib, name).restype = ctypes.c_int
    lib.sf_frame2_blocks_per_sm.argtypes = [ctypes.c_int] * 7
    lib.sf_frame2_blocks_per_sm.restype = ctypes.c_int
    lib.sf_slots_shared_bytes.argtypes = [ctypes.c_int] * 2
    lib.sf_slots_shared_bytes.restype = ctypes.c_longlong
    lib.sf_slots_blocks_per_sm.argtypes = [ctypes.c_int] * 2
    lib.sf_slots_blocks_per_sm.restype = ctypes.c_int
    lib.sf_tile_substep_blocks_per_sm.argtypes = [ctypes.c_int] * 3
    lib.sf_tile_substep_blocks_per_sm.restype = ctypes.c_int
    for name in ("sf_tile_frame_blocks_per_sm",
                 "sf_tile_compound_frame_blocks_per_sm"):
        getattr(lib, name).argtypes = [ctypes.c_int]
        getattr(lib, name).restype = ctypes.c_int
    for name in ("sf_tile_tables_blocks_per_sm", "sf_tile_ccd_blocks_per_sm"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    lib.sf_tile_manifold_shared_bytes.argtypes = [ctypes.c_int] * 3
    lib.sf_tile_manifold_shared_bytes.restype = ctypes.c_longlong
    lib.sf_tile_manifold_blocks_per_sm.argtypes = [ctypes.c_int] * 3
    lib.sf_tile_manifold_blocks_per_sm.restype = ctypes.c_int
    lib.sf_tile_manifold_width.argtypes = [ctypes.c_int]
    lib.sf_tile_manifold_width.restype = ctypes.c_int
    lib.sf_tile_solve_fields.argtypes = []
    lib.sf_tile_solve_fields.restype = ctypes.c_int
    lib.sf_error_string.argtypes = [ctypes.c_int]
    lib.sf_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def launch(name: str, args: ctypes.Structure, device) -> None:
    """Call entry point ``name`` on the current stream of ``device``."""
    import torch

    stream = torch.cuda.current_stream(device).cuda_stream
    lib = library()
    err = getattr(lib, name)(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch "
                           f"({lib.sf_error_string(err).decode()})")


def ptr(t) -> int:
    return t.data_ptr()
