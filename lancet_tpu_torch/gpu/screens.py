"""The device graph engine's two screens: the hand-written CUDA kernels of
`csrc/screens.cu` and the dispatch to their plain versions.

The JAX package runs each screen as one device loop inside its jitted
attempt; PyTorch would launch every op of the loop's body from the host
(tens of thousands of ops a `tandem_at` call) and sync on the predicate of
each of `cycle_screen`'s two fixpoint loops, every round. Here each is one
kernel launch per call:

- `tandem_at` (JAX `tpu/stages.py::tandem_at`, :630, a `lax.scan`): the
  findTandems position probe of the short-link STR guard, one warp a
  candidate string, for each unit length 32 positions at a time across
  the lanes (`tandem_plan` sizes the block's shared memory);
- `cycle_screen` (`tpu/stages.py::cycle_screen`, :750, two
  `lax.while_loop`s): the conservative cycle screen, one block a window,
  both fixpoints in the same rounds on the card, one barrier a round
  (`cycle_screen_plan`).

Each wrapper takes tensors on one device and raises, before any work, when
its inputs span two. On the CPU it runs the plain version
(gpu.stages.tandem_at_plain, gpu.stages.cycle_screen_plain: the JAX loops
step for step); on a CUDA device it launches the kernel on that device and
raises, before the launch, for shapes the kernel does not take, and after
it if the library cannot be built or the launch is refused. There is no
fallback from the card to the plain version. The kernels read the engine's
int64 and bool tensors as they are (no narrowing copy). Each launch adds
one to `LAUNCHES[name]`.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from .._build import build_shared
from . import count_launch, input_device
from .gotoh import NVCC_FLAGS, SMEM_LIMIT, _nvcc, _r16, _stream

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "screens.cu")
LAUNCHES = {"tandem_at": 0, "cycle_screen": 0}

TANDEM_WARPS = 8  # strings a tandem_at block, one warp each, at most
TANDEM_MAX_UNIT = 8  # unit lengths the kernel is instantiated for
SCREEN_MAX_ITEMS = 32767  # a state id (2 NI of them) fits 16 bits
SCREEN_MAX_EDGES = 65535  # an in-degree fits 16 bits
_I64 = (-2**63, 2**63 - 1)

_lib = None
_lib_lock = threading.Lock()


def _tandem_string_smem(L: int, max_unit_len: int) -> int:
    """One string's shared memory: its codes with the sentinels a chain
    reads (L + max_unit_len int64) and max_unit_len - 1 prefix-sum arrays
    of L + 1 int32 counts."""
    mu = max(max_unit_len, 0)
    return _r16((L + mu) * 8) + _r16(max(mu - 1, 0) * (L + 1) * 4)


def tandem_warps(L: int, max_unit_len: int) -> int:
    """Strings (warps) a tandem_at block takes, as csrc/screens.cu's
    tandem_warps: TANDEM_WARPS, or as many as fit in a block's shared
    memory (0: one does not)."""
    per = _tandem_string_smem(L, max_unit_len)
    return TANDEM_WARPS if per == 0 else min(TANDEM_WARPS, SMEM_LIMIT // per)


def tandem_smem(L: int, max_unit_len: int) -> int:
    """A tandem_at block's shared memory, as csrc/screens.cu's tandem_smem:
    tandem_warps strings' codes and prefix sums."""
    return tandem_warps(L, max_unit_len) * _tandem_string_smem(L,
                                                               max_unit_len)


def tandem_plan(L: int, max_unit_len: int) -> int:
    """The bytes of shared memory a tandem_at block takes (10,624 at the
    engine's L 64 and unit length 4: under 48 KB, so a launch sets no
    attribute). Raises for a unit length past TANDEM_MAX_UNIT (the
    kernel's instantiations) or a string whose rows do not fit in a
    block's shared memory (L past ~6,400 at unit length 8)."""
    if max_unit_len > TANDEM_MAX_UNIT:
        raise ValueError(f"tandem_at takes max_unit_len <= "
                         f"{TANDEM_MAX_UNIT}, got {max_unit_len}")
    mu = max(max_unit_len, 0)
    if tandem_warps(L, mu) < 1:
        raise ValueError(f"tandem_at: strings of L={L} codes do not fit in "
                         f"a block's shared memory")
    return tandem_smem(L, mu)


def cycle_screen_smem(NI: int, EE: int, Cmax: int) -> int:
    """A cycle_screen block's shared memory, as csrc/screens.cu's
    cycle_screen_smem: the list counters, the edge words (4 bytes an edge),
    the reach and layer labels and the in-degrees (2 bytes a state each),
    the items' flags (1) and components (2), two flags a component slot."""
    return (16 + _r16(EE * 4) + 3 * _r16(NI * 4) + _r16(NI) + _r16(NI * 2)
            + 2 * _r16(Cmax + 1))


def cycle_screen_plan(NI: int, EE: int, N: int, Cmax: int) -> int:
    """The bytes of shared memory a cycle_screen block takes (14,240 at the
    engine's NI 528, EE 1,568, Cmax 8). Raises for more than 32,767 items
    (a state id in 16 bits) or 65,535 edges (an in-degree in 16 bits; a
    block's shared memory holds ~58,000), anchors N + 2c outside the items
    (the plain version's index fails there), Cmax < 0 or a window beyond a
    block's shared memory."""
    if not 1 <= NI <= SCREEN_MAX_ITEMS:
        raise ValueError(f"cycle_screen takes 1 to {SCREEN_MAX_ITEMS} items, "
                         f"got NI={NI}")
    if EE > SCREEN_MAX_EDGES:
        raise ValueError(f"cycle_screen: a window of EE={EE} edges does not "
                         f"fit in a block's shared memory")
    if Cmax < 0 or N < 0 or (Cmax > 0 and N + 2 * (Cmax - 1) >= NI):
        raise ValueError(f"cycle_screen: the anchors N + 2c (N={N}, c < "
                         f"Cmax={Cmax}) must be items of [0, {NI})")
    smem = cycle_screen_smem(NI, EE, Cmax)
    if smem > SMEM_LIMIT:
        raise ValueError(f"cycle_screen: a window of NI={NI} items and "
                         f"EE={EE} edges does not fit in a block's shared "
                         f"memory")
    return smem


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build() -> str:
    """Compile csrc/screens.cu for sm_90a (if not built yet); returns the
    .so path. Raises _build.BuildError with nvcc's error text."""
    return build_shared(_SRC, "libscreens", [_nvcc()] + NVCC_FLAGS + [_SRC])


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp, ci = ctypes.c_void_p, ctypes.c_int
            ll, sz = ctypes.c_longlong, ctypes.c_size_t
            lib.tandem_at.restype = lib.cycle_screen.restype = ci
            lib.tandem_at.argtypes = [vp] * 3 + [ci] * 3 + [ll] * 4 + [sz, vp]
            lib.cycle_screen.argtypes = [vp] * 8 + [ci] * 6 + [sz, vp]
            _lib = lib
        return _lib


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    count_launch(LAUNCHES, name)


def _device(name: str, *tensors) -> torch.device:
    dev = input_device(name, *tensors)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _ints(name: str, **tensors) -> list:
    """The tensors as int64, contiguous (no copy where they already are);
    raises for a float, complex or bool tensor."""
    out = []
    for k, t in tensors.items():
        if t.is_floating_point() or t.is_complex() or t.dtype == torch.bool:
            raise ValueError(f"{name} takes integer {k}, got {t.dtype}")
        out.append(t.to(torch.int64).contiguous())
    return out


def _flags(*tensors) -> list:
    return [t.to(torch.bool).contiguous() for t in tensors]


def _scalar(name: str, **vals) -> list:
    out = []
    for k, v in vals.items():
        v = int(v)
        if not _I64[0] <= v <= _I64[1]:
            raise ValueError(f"{name}: {k}={v} is outside int64")
        out.append(v)
    return out


# ---------------------------------------------------------------------------
# tandem_at
# ---------------------------------------------------------------------------

def tandem_at(seqs, lens, pos, max_unit_len, min_report_units,
              min_report_len, dist_from_str):
    """The findTandems position probe (gpu.stages.tandem_at_plain) of each
    string: seqs [B, L] integer codes, lens [B]; returns [B] bool. On the
    card one warp a string tests 32 positions at a time for each unit
    length (tandem_plan)."""
    dev = _device("tandem_at", seqs, lens)
    if dev.type == "cpu":
        from .stages import tandem_at_plain

        return tandem_at_plain(seqs, lens, pos, max_unit_len,
                               min_report_units, min_report_len,
                               dist_from_str)
    if seqs.dim() != 2 or tuple(lens.shape) != (seqs.shape[0],):
        raise ValueError(f"tandem_at takes seqs [B, L] and lens [B], got "
                         f"{tuple(seqs.shape)} and {tuple(lens.shape)}")
    B, L = seqs.shape
    smem = tandem_plan(L, int(max_unit_len))
    args = _scalar("tandem_at", pos=pos, min_report_units=min_report_units,
                   min_report_len=min_report_len, dist_from_str=dist_from_str)
    out = torch.empty((B,), dtype=torch.bool, device=dev)
    if B == 0:
        return out
    s, n = _ints("tandem_at", seqs=seqs, lens=lens)
    with torch.cuda.device(dev):  # the launch goes to the current device
        rc = _load().tandem_at(s.data_ptr(), n.data_ptr(), out.data_ptr(), B,
                               L, max(int(max_unit_len), 0), *args, smem,
                               _stream(dev))
    _launched("tandem_at", rc)
    return out


# ---------------------------------------------------------------------------
# cycle_screen
# ---------------------------------------------------------------------------

def cycle_screen(e_src, e_dst, e_dir, e_alive, alive, special, comp, N, NI,
                 Cmax, T=32):
    """The conservative cycle screen (gpu.stages.cycle_screen_plain):
    e_src, e_dst, e_dir, e_alive [W, EE]; alive, special, comp [W, NI];
    returns may_cycle [W, Cmax] bool. On the card one block a window
    stages its active edges' state ids and runs both fixpoints in the same
    rounds in shared memory (cycle_screen_plan)."""
    dev = _device("cycle_screen", e_src, e_dst, e_dir, e_alive, alive,
                  special, comp)
    if dev.type == "cpu":
        from .stages import cycle_screen_plain

        return cycle_screen_plain(e_src, e_dst, e_dir, e_alive, alive,
                                  special, comp, N, NI, Cmax, T)
    W, EE = e_src.shape
    if (any(tuple(t.shape) != (W, EE) for t in (e_dst, e_dir, e_alive))
            or any(tuple(t.shape) != (W, NI) for t in (alive, special, comp))):
        shapes = [tuple(t.shape) for t in (e_src, e_dst, e_dir, e_alive,
                                           alive, special, comp)]
        raise ValueError(f"cycle_screen takes edges [W, EE] and items [W, "
                         f"NI={NI}], got {shapes}")
    smem = cycle_screen_plan(NI, EE, int(N), int(Cmax))
    out = torch.empty((W, Cmax), dtype=torch.bool, device=dev)
    if W == 0:
        return out
    ins = (*_ints("cycle_screen", e_src=e_src, e_dst=e_dst, e_dir=e_dir),
           *_flags(e_alive, alive, special), *_ints("cycle_screen",
                                                    comp=comp))
    rounds = max(min(int(T), 2**31 - 1), -1)
    with torch.cuda.device(dev):
        rc = _load().cycle_screen(*[t.data_ptr() for t in ins],
                                  out.data_ptr(), W, NI, EE, int(N),
                                  int(Cmax), rounds, smem, _stream(dev))
    _launched("cycle_screen", rc)
    return out
