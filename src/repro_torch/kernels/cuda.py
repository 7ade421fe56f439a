"""Build, bind and launch the port's CUDA kernels.

All members live in one compilation unit (``csrc/bundle.cu`` and its
headers) because any member must be able to share a launch with any other;
the two standalone kernels the reference never fuses, the tiled matmul and
flash attention, are their own ``__global__`` kernels in the same library,
each with its own C launcher (``matmul``, ``flash_attention`` below).
The bundle kernel itself has six instances (row members only, with and
without the row family's chain bodies; the paper members only; maxpool
alone; any mix, with and without the chain bodies); ``hf_launch``
picks the narrowest one that holds the members a launch carries
(``launch_instance`` names it).
The library is compiled with ``nvcc`` for ``sm_90a`` at first use, into
``build/repro_torch/<hash of the sources>/`` at the root of the checkout,
bound with ``ctypes`` (plain C interface, no PyTorch headers: seconds to
build), and launched on PyTorch's current stream.  Nothing here runs at
import: the CPU tests import every module.

``Kernel`` records one hand-written kernel of the port: where its source
is, which TPU kernel it replaces, and ``launches``, its launch count.  Each
kernel module holds its own record.  A count is bumped right after its
kernel's launch and nowhere else: ``core/hfuse.py`` bumps the bundle
launcher's and that of every member a launch carried; a standalone
kernel's wrapper (``kernels/matmul.matmul``,
``kernels/flash_attention``) bumps its own.

The build keeps ptxas's report (``-Xptxas -v``) beside the library:
``ptxas_usage`` reads each function's registers, stack and spills from it.
``sass_counts`` counts an instruction (``HMMA``: ``mma.sync`` on the
tensor cores; ``HGMMA``: ``wgmma``) in each function of the library's
machine code, the non-inlined member bodies inside each bundle instance
included.  ``workspace`` keeps a member's workspace across launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import re
import shutil
import subprocess
import tempfile
import time
from collections import OrderedDict
from pathlib import Path
from typing import Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
MAX_MEMBERS = 8

# member kinds (csrc/common.cuh)
ROW, DECODE_ATTN, PREFILL_ATTN, ADAMW = 1, 2, 3, 4
MAXPOOL, UPSAMPLE, BNSTATS, IM2COL, HIST, ETHASH, HASH = 5, 6, 7, 8, 9, 10, 11
MOE_GMM = 12


class Kernel:
    """One hand-written CUDA kernel of the port and its launch count."""

    def __init__(self, name: str, source: str, replaces: str):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.launches = 0

    def __repr__(self):
        return f"Kernel({self.name!r}, launches={self.launches})"


def reset_counts(kernels: Sequence[Kernel]) -> None:
    for k in kernels:
        k.launches = 0


class MemberDesc(ctypes.Structure):
    _fields_ = [("kind", ctypes.c_int), ("ctas", ctypes.c_int),
                ("ratio", ctypes.c_int), ("offset", ctypes.c_int),
                ("i", ctypes.c_int * 16), ("f", ctypes.c_float * 8),
                ("inp", ctypes.c_void_p * 6), ("out", ctypes.c_void_p * 4)]


class BundleDesc(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int), ("period", ctypes.c_int),
                ("m", MemberDesc * MAX_MEMBERS)]


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------
_lib = None


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "with the CUDA toolkit on the machine with the card")


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/bundle.cu`` unless the library for these exact
    sources exists; returns its path.  The output lands atomically, so
    concurrent first uses cannot load a half-written file."""
    out_dir = BUILD_ROOT / source_hash()
    so = out_dir / "libhfuse.so"
    if so.exists():
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / "bundle.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr, end="")
        print(f"[build] nvcc {time.perf_counter() - t0:.1f}s -> {so}")
    (out_dir / "ptxas.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so


def ptxas_usage() -> dict[str, dict[str, int]]:
    """``parse_ptxas`` of the library's build report."""
    return parse_ptxas((build().parent / "ptxas.log").read_text())


def parse_ptxas(report: str) -> dict[str, dict[str, int]]:
    """Per function of a ``-Xptxas -v`` report (mangled name): ``stack``,
    ``spill_stores`` and ``spill_loads`` bytes, and for kernels
    ``registers``.  A non-inlined function is compiled once per kernel that
    calls it; it gets the largest of its figures."""
    out: dict[str, dict[str, int]] = {}
    name = None
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            got = out.setdefault(name, {})
            for key, val in zip(("stack", "spill_stores", "spill_loads"),
                                m.groups()):
                got[key] = max(got.get(key, 0), int(val))
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def sass_counts(opcode: str = "HMMA") -> dict[str, int] | None:
    """Per function of the library's SASS (mangled name): how many
    ``opcode`` instructions it holds, by ``cuobjdump -sass``; None where the
    toolkit has no cuobjdump.  A kernel's count includes the non-inlined
    device functions compiled into it; each of those also gets its own
    entry, ``kernel$function``, from the span the ELF symbol table
    (``cuobjdump -elf``) gives it inside the kernel's code."""
    tool = Path(_nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    lib = str(build())
    sass, elf = (subprocess.run([str(tool), flag, lib], capture_output=True,
                                text=True, check=True).stdout
                 for flag in ("-sass", "-elf"))
    spans: dict[str, list[tuple[int, int, str]]] = {}
    for line in elf.splitlines():
        m = re.match(r"\s*0x[0-9a-f]+\s+(0x[0-9a-f]+)\s+(0x[0-9a-f]+)\s+"
                     r"\S+\s+\S+\s+\S+\s+\$(\w+)\$(\w+)\s*$", line)
        if m:
            lo = int(m.group(1), 16)
            spans.setdefault(m.group(3), []).append(
                (lo, lo + int(m.group(2), 16), f"{m.group(3)}${m.group(4)}"))
    counts: dict[str, int] = {}
    name = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
            for _lo, _hi, sub in spans.get(name, ()):
                counts[sub] = 0
        elif name and re.search(rf"\b{opcode}\b", line):
            counts[name] += 1
            at = re.search(r"/\*([0-9a-f]+)\*/", line)
            for lo, hi, sub in spans.get(name, ()):
                if at and lo <= int(at.group(1), 16) < hi:
                    counts[sub] += 1
    return counts


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.hf_desc_sizes.argtypes = [ctypes.POINTER(ctypes.c_int),
                                      ctypes.POINTER(ctypes.c_int)]
        lib.hf_desc_sizes.restype = ctypes.c_int
        lib.hf_member_smem.argtypes = [ctypes.POINTER(MemberDesc)]
        lib.hf_member_smem.restype = ctypes.c_int
        lib.hf_launch.argtypes = [ctypes.POINTER(BundleDesc), ctypes.c_int,
                                  ctypes.c_int, ctypes.c_void_p]
        lib.hf_launch.restype = ctypes.c_int
        lib.hf_occupancy.argtypes = [ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_int)]
        lib.hf_occupancy.restype = ctypes.c_int
        lib.hf_launch_instance.argtypes = [
            ctypes.POINTER(BundleDesc), ctypes.c_int,
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int)]
        lib.hf_launch_instance.restype = ctypes.c_int
        lib.hf_error_string.argtypes = [ctypes.c_int]
        lib.hf_error_string.restype = ctypes.c_char_p
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.hf_matmul.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ptr]
        lib.hf_matmul.restype = i32
        lib.hf_matmul_smem.argtypes = [i32]
        lib.hf_matmul_smem.restype = i32
        lib.hf_flash_attention.argtypes = [ptr, ptr, ptr, ptr, *(i32,) * 7,
                                           ctypes.c_float, ptr]
        lib.hf_flash_attention.restype = i32
        lib.hf_gmm_tmaps.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32]
        lib.hf_gmm_tmaps.restype = i32
        ms, bs = ctypes.c_int(), ctypes.c_int()
        lib.hf_desc_sizes(ctypes.byref(ms), ctypes.byref(bs))
        if (ms.value, bs.value) != (ctypes.sizeof(MemberDesc),
                                    ctypes.sizeof(BundleDesc)):
            raise RuntimeError(
                f"descriptor layout mismatch: C {ms.value}/{bs.value} bytes, "
                f"ctypes {ctypes.sizeof(MemberDesc)}/"
                f"{ctypes.sizeof(BundleDesc)}")
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# Operand checks (before any pointer reaches the kernel)
# ---------------------------------------------------------------------------
def check(t: torch.Tensor, what: str, shape: Sequence[int],
          dtype: torch.dtype) -> int:
    """Validate one operand and return its device pointer."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, kernel takes "
                         f"{tuple(shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: dtype {t.dtype}, kernel takes {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: must be 16-byte aligned")
    return t.data_ptr()


# ---------------------------------------------------------------------------
# Launch
# ---------------------------------------------------------------------------
def grid_size(ctas: Sequence[int], ratios: Sequence[int]) -> int:
    """CTAs of the bundle launch: max_i ceil(ctas_i / r_i) * period."""
    return max(math.ceil(c / r) for c, r in zip(ctas, ratios)) * sum(ratios)


_WORKSPACES: dict[tuple, tuple[torch.Tensor, ...]] = {}
_USES: dict[tuple, int] = {}     # workspace requests of the launch being packed


def workspace(dev: torch.device, key: tuple,
              sizes: Sequence[tuple[int, torch.dtype]]
              ) -> tuple[torch.Tensor, ...]:
    """A member's workspace that persists across launches: one zeroed
    tensor per (elements, dtype) of ``sizes``, kept per device, stream,
    ``key``, ``sizes`` and the request's rank among the launch's requests
    of ``key``, so two members of one launch never share one and a later
    launch on the stream reuses it.  A kernel that keeps tickets here must
    leave them at zero when it ends."""
    key = (key, tuple((int(c), dt) for c, dt in sizes))
    n = _USES.get(key, 0)
    _USES[key] = n + 1
    full = (dev.index, torch.cuda.current_stream(dev).cuda_stream, key, n)
    got = _WORKSPACES.get(full)
    if got is None:
        got = _WORKSPACES[full] = tuple(
            torch.zeros(max(count, 1), dtype=dt, device=dev)
            for count, dt in sizes)
    return got


def _describe(members: Sequence, ins: Sequence[Sequence[torch.Tensor]],
              outs: Sequence[Sequence[torch.Tensor]],
              ratios: Sequence[int]) -> tuple[BundleDesc, int, list]:
    """The launch's descriptor, its dynamic shared memory per CTA (the
    largest any member needs) and the members' workspaces (alive until the
    launch is queued)."""
    if not 1 <= len(members) <= MAX_MEMBERS:
        raise ValueError(f"a bundle holds 1..{MAX_MEMBERS} members, "
                         f"got {len(members)}")
    lib = library()
    _USES.clear()
    desc = BundleDesc()
    desc.n = len(members)
    desc.period = sum(ratios)
    offset, smem = 0, 0
    held = []
    for j, (mem, i_, o_, r) in enumerate(zip(members, ins, outs, ratios)):
        md = desc.m[j]
        held.append(mem.pack(md, i_, o_))
        md.ctas, md.ratio, md.offset = mem.ctas, r, offset
        offset += r
        need = lib.hf_member_smem(ctypes.byref(md))
        if need < 0:
            raise ValueError(f"unknown member kind {md.kind}")
        smem = max(smem, need)
    return desc, smem, held


def launch_smem(members: Sequence, ins: Sequence[Sequence[torch.Tensor]],
                outs: Sequence[Sequence[torch.Tensor]]) -> int:
    """Dynamic shared memory per CTA of a launch carrying ``members`` with
    these operands (nothing is launched)."""
    return _describe(members, ins, outs, [1] * len(members))[1]


def launch(members: Sequence, ins: Sequence[Sequence[torch.Tensor]],
           outs: Sequence[Sequence[torch.Tensor]],
           ratios: Sequence[int]) -> None:
    """One launch of the bundle kernel carrying ``members`` with their
    operands, CTAs partitioned by ``ratios``, on PyTorch's current stream
    of the current device.
    Raises if the launch is refused; faults during the run surface at the
    next synchronisation."""
    desc, smem, _held = _describe(members, ins, outs, ratios)
    grid = grid_size([m.ctas for m in members], ratios)
    stream = torch.cuda.current_stream().cuda_stream
    lib = library()
    err = lib.hf_launch(ctypes.byref(desc), grid, smem,
                        ctypes.c_void_p(stream))
    if err:
        raise RuntimeError("bundle launch failed: "
                           + lib.hf_error_string(err).decode())


def _raise_if(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           + library().hf_error_string(err).decode())


def matmul(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor) -> None:
    """One launch of the tiled matmul (``csrc/tiled_matmul.cuh``): out =
    x @ w, all three bf16 or all fp32, checked by the caller; the bf16
    kernel's two TMA tensor maps are encoded by the launcher."""
    (M, K), N = x.shape, w.shape[1]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().hf_matmul(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K,
            int(x.dtype == torch.float32), ctypes.c_void_p(stream))
    if err == -1 or err >= 1000:
        raise RuntimeError(f"tiled matmul: tensor map error {err} (-1: no "
                           f"cuTensorMapEncodeTiled; 1000 + CUresult)")
    _raise_if(err, "tiled matmul")


def matmul_smem(fp32: bool) -> int:
    """Dynamic shared memory per CTA of the tiled matmul's fp32 or bf16
    kernel (its ring of stages)."""
    return library().hf_matmul_smem(int(fp32))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    o: torch.Tensor, causal: bool, scale: float) -> None:
    """One launch of flash attention (``csrc/flash_attention.cuh``): q, o
    (B,S,H,D), k, v (B,S,Hkv,D), all bf16 (the tensor-core kernel) or all
    fp32 (the CUDA-core kernel), checked by the caller."""
    B, S, H, D = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_if(library().hf_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, H,
            k.shape[2], D, int(q.dtype == torch.float32), int(causal),
            scale, ctypes.c_void_p(stream)), "flash attention")


_TMAPS: OrderedDict[tuple, torch.Tensor] = OrderedDict()
TMAPS_KEPT = 32     # weight pairs whose tensor maps stay on the card


def gmm_tensor_maps(w_in: torch.Tensor, w_out: torch.Tensor, E: int, d: int,
                    f: int, fin: int) -> int:
    """Device pointer to the grouped expert FFN's two TMA tensor maps of
    w_in (E, d, fin) and w_out (E, f, d) (``hf_gmm_tmaps``), encoded once
    per pair of weight addresses and shapes: a map holds only the address,
    shape and strides, so it stays right for whatever tensor occupies the
    memory later.  The ``TMAPS_KEPT`` pairs used last keep theirs (a model
    uses one pair a layer); an evicted map's memory goes back to PyTorch's
    allocator, which hands it only to work queued after the launches that
    read it."""
    key = (w_in.device.index, w_in.data_ptr(), w_out.data_ptr(), E, d, f,
           fin)
    maps = _TMAPS.get(key)
    if maps is None:
        buf = (ctypes.c_ubyte * 320)()
        at = (ctypes.addressof(buf) + 63) & ~63
        err = library().hf_gmm_tmaps(ctypes.c_void_p(at), w_in.data_ptr(),
                                     w_out.data_ptr(), E, d, f, fin)
        if err:
            raise RuntimeError(f"moe_gmm tensor maps: error {err}")
        host = torch.frombuffer(bytearray(ctypes.string_at(at, 256)),
                                dtype=torch.uint8)
        maps = _TMAPS[key] = host.to(w_in.device)
        while len(_TMAPS) > TMAPS_KEPT:
            _TMAPS.popitem(last=False)
    else:
        _TMAPS.move_to_end(key)
    return maps.data_ptr()


def member_smem(member) -> int:
    """Dynamic shared memory one member needs per CTA, from the kernel
    library (members with a ``describe`` method: the paper members)."""
    md = MemberDesc()
    member.describe(md)
    need = library().hf_member_smem(ctypes.byref(md))
    if need < 0:
        raise ValueError(f"unknown member kind {md.kind}")
    return need


def launch_instance(members: Sequence,
                    ins: Sequence[Sequence[torch.Tensor]],
                    outs: Sequence[Sequence[torch.Tensor]]) -> tuple[str, int]:
    """(name of the bundle kernel instance a launch carrying ``members``
    with these operands runs, its CTAs resident on one SM at the launch's
    shared memory), from the library; nothing is launched."""
    desc, smem, _held = _describe(members, ins, outs, [1] * len(members))
    inst, n = ctypes.c_char_p(), ctypes.c_int()
    err = library().hf_launch_instance(ctypes.byref(desc), smem,
                                       ctypes.byref(inst), ctypes.byref(n))
    if err:
        raise RuntimeError("occupancy query failed: "
                           + library().hf_error_string(err).decode())
    return inst.value.decode(), n.value


def occupancy(smem: int) -> int:
    """CTAs of a bundle launch with ``smem`` bytes of dynamic shared memory
    per CTA that are resident on one SM at once."""
    n = ctypes.c_int()
    err = library().hf_occupancy(smem, ctypes.byref(n))
    if err:
        raise RuntimeError("occupancy query failed: "
                           + library().hf_error_string(err).decode())
    return n.value
