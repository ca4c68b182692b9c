"""Build and bind the package's CUDA kernels.

Each source under `csrc/` is compiled by its own `nvcc` process, all
started together, and one more `nvcc` call links the objects into a shared
library with a plain C interface, which is loaded with `ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -Xptxas -v -c csrc/<name>.cu -o _build/<name>.o   # one per source
    nvcc -shared -o _build/liboc_kernels_<hash>.so _build/*.o

(ptxas's register and spill report goes to the `.log` beside the library.)

The library lands in `overcooked_ai_tpu_torch/_build/` at first use, named
by a hash of the sources and flags, so a warm run loads it without
rebuilding and an edited source rebuilds. Nothing here runs at import.

This module also owns the Python side of the C interface: the `LayoutData`
word block of `csrc/overcooked_step.cuh` (`layout_words`), its 52-word
`RecipeTables` part (`table_words`, also per lane) and the `StateArrays`
pointer struct (`state_arrays`).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

import numpy as np
import torch

from overcooked_ai_tpu_torch.core.layout import Layout
from overcooked_ai_tpu_torch.core.state import State, to_torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
LINK_FLAGS = ["-shared"]

# sizes of csrc/overcooked_step.cuh
MAX_HW = 128
MAX_P = 4
SEQ_MAX = 2047
HEADER_WORDS = 5  # then the RecipeTables words
# the layout fields of a `RecipeTables` block, in its word order
TABLE_FIELDS = ("old_dynamics", "placement_in_pot_rew", "dish_pickup_rew", "soup_pickup_rew",
                "time_table", "delivery_value", "opt_value")
TABLE_WORDS = 4 + 3 * 16
LAYOUT_WORDS = HEADER_WORDS + TABLE_WORDS + 2 * MAX_HW + 8 * MAX_P

_lib = None  # the loaded library, once per process
# id(layout) -> (layout, its LayoutData words); holding the layout keeps
# its id from being reused while the entry lives
_words_cache: dict[int, tuple[Layout, np.ndarray]] = {}
_WORDS_CACHE_SIZE = 64
# (id(layout), device) -> (layout, its RecipeTables words on the device)
_rows_cache: dict[tuple[int, str], tuple[Layout, torch.Tensor]] = {}


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")) +
                  glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def _finish(cmd: list, proc: subprocess.Popen) -> str:
    """Wait for one compiler process; its stderr, or RuntimeError if it failed."""
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
    return err


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"liboc_kernels_{h.hexdigest()[:16]}.so")


def build() -> tuple[str, bool, float]:
    """Compile the kernels unless a library of these sources exists.

    Returns (library path, whether it was compiled now, seconds taken).
    Raises RuntimeError with the compiler's output if the build fails.
    """
    t0 = time.perf_counter()
    path = library_path()
    if os.path.exists(path):
        return path, False, time.perf_counter() - t0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    objs, procs = [], []
    try:
        for src in (p for p in _sources() if p.endswith(".cu")):
            objs.append(f"{tmp}.{os.path.basename(src)[:-3]}.o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", objs[-1]]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        report = [_finish(cmd, proc) for cmd, proc in procs]
        link = [nvcc, *LINK_FLAGS, "-o", tmp, *objs]
        _finish(link, subprocess.Popen(link, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True))
    finally:
        for _, proc in procs:  # a failed build leaves no compiler running
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    with open(path[:-3] + ".log", "w") as f:  # ptxas register / spill report
        f.write("".join(report))
    os.replace(tmp, path)
    return path, True, time.perf_counter() - t0


class StateArrays(ctypes.Structure):
    """`StateArrays` of csrc/overcooked_step.cuh: one pointer per field."""

    _fields_ = [(name, ctypes.c_void_p) for name in State._fields]


def load():
    """The kernel library, built on first use; C signatures declared."""
    global _lib
    if _lib is None:
        path, _, _ = build()
        lib = ctypes.CDLL(path)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.oc_layout_words.argtypes = []
        lib.oc_layout_words.restype = i
        lib.oc_fused_rollout.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        lib.oc_fused_rollout.restype = i
        lib.oc_fused_train_step.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
        lib.oc_fused_train_step.restype = i
        lib.oc_fused_pool_rollout.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p]
        lib.oc_fused_pool_rollout.restype = i
        lib.oc_fused_pool_train_step.argtypes = [p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i,
                                                 i, i, i, i, p]
        lib.oc_fused_pool_train_step.restype = i
        if lib.oc_layout_words() != LAYOUT_WORDS:
            raise RuntimeError(
                f"LayoutData has {lib.oc_layout_words()} words in C, "
                f"{LAYOUT_WORDS} in Python"
            )
        _lib = lib
    return _lib


def check_launch(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {err}")


def pack_cell_words(obj, soup_ing, soup_tick, obj_seq, num_cells: int) -> torch.Tensor:
    """Cell fields -> the kernels' packed cell words (torch, any device).

    obj, soup_tick, obj_seq: (HW, ...); soup_ing: (HW, 3, ...).
    """
    stamp = torch.clamp(obj_seq + num_cells, max=SEQ_MAX) & SEQ_MAX
    return (
        (obj & 7) | ((soup_ing[:, 0] & 3) << 3) | ((soup_ing[:, 1] & 3) << 5)
        | ((soup_ing[:, 2] & 3) << 7) | (((soup_tick + 1) & 255) << 9) | (stamp << 17)
    )


def table_words(layout: Layout) -> torch.Tensor:
    """The `RecipeTables` words of a layout, (52,), or of a per-lane layout,
    (B, 52): int32, on the layout's device (the CPU for numpy leaves)."""
    lead = tuple(layout.terrain.shape[2:])  # () or (B,)
    cols = [torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
            .to(torch.int32).reshape(-1, *lead)
            for x in (getattr(layout, name) for name in TABLE_FIELDS)]
    return torch.cat(cols).movedim(0, -1).contiguous()


def table_row_on(layout: Layout, device) -> torch.Tensor:
    """The layout's `RecipeTables` words as a (1, 52) int32 tensor on
    `device`, copied there once per layout object and device: B1 reads its
    tables from device memory, as B3 reads the lanes' rows."""
    key = (id(layout), str(device))
    hit = _rows_cache.get(key)
    if hit is None:
        if len(_rows_cache) >= _WORDS_CACHE_SIZE:
            _rows_cache.clear()
        hit = _rows_cache[key] = (layout, table_words(layout).reshape(1, -1).to(device))
    return hit[1]


def layout_words(layout: Layout) -> np.ndarray:
    """`Layout` -> the int32 `LayoutData` block the kernels read, built once
    per layout object (read-only; a launch passes it by pointer)."""
    hit = _words_cache.get(id(layout))
    if hit is not None:
        return hit[1]
    if len(_words_cache) >= _WORDS_CACHE_SIZE:
        _words_cache.clear()
    words = _build_layout_words(layout)
    words.flags.writeable = False
    _words_cache[id(layout)] = (layout, words)
    return words


def _build_layout_words(layout: Layout) -> np.ndarray:
    H, W = layout.terrain.shape
    HW = H * W
    start = layout.start_state
    P = start.pos.shape[0]
    if HW > MAX_HW or not 1 <= P <= MAX_P:
        raise ValueError(f"kernels take HW <= {MAX_HW} and 1 <= P <= {MAX_P}, got {HW}, {P}")
    terrain = np.asarray(layout.terrain, np.int64).reshape(HW)

    words = np.zeros(LAYOUT_WORDS, np.int64)
    words[:HEADER_WORDS] = [H, W, HW, P, int(layout.num_pots)]
    o = HEADER_WORDS
    words[o:o + TABLE_WORDS] = table_words(layout).numpy()
    o += TABLE_WORDS
    words[o:o + HW] = terrain
    o += MAX_HW
    cell = to_torch(start, "cpu")
    words[o:o + HW] = pack_cell_words(
        cell.obj.reshape(HW), cell.soup_ing.reshape(HW, 3), cell.soup_tick.reshape(HW),
        cell.obj_seq.reshape(HW), HW,
    ).numpy()
    o += MAX_HW
    players = np.concatenate(
        [np.asarray(start.pos), np.asarray(start.orient)[:, None],
         np.asarray(start.held)[:, None], np.asarray(start.held_soup),
         np.asarray(start.held_soup_tick)[:, None]], axis=1,
    )  # (P, 8)
    words[o:o + 8 * P] = players.reshape(-1)
    return words.astype(np.int32)


def state_arrays(state: State) -> StateArrays:
    return StateArrays(*(x.data_ptr() for x in state))


def check_state(state: State, layout: Layout, batch: int, device) -> None:
    """Raise unless `state` is a batch-last int32 contiguous state of
    `layout` with `batch` envs on `device`."""
    H, W = layout.terrain.shape[:2]
    P = layout.start_state.pos.shape[0]
    want = State(
        pos=(P, 2, batch), orient=(P, batch), held=(P, batch),
        held_soup=(P, 3, batch), held_soup_tick=(P, batch), obj=(H, W, batch),
        soup_ing=(H, W, 3, batch), soup_tick=(H, W, batch), obj_seq=(H, W, batch),
        t=(batch,),
    )
    for name, x, shape in zip(State._fields, state, want):
        if not torch.is_tensor(x) or x.device != device:
            raise ValueError(f"state.{name} must be a tensor on {device}")
        if x.dtype != torch.int32 or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(
                f"state.{name}: want contiguous int32 {shape}, got "
                f"{x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}"
            )
