"""The host heap's policy that `portbench/run.py` fixes before a run: a served
1920x1080 frame comes from memory the process keeps, never from a new mapping."""

from __future__ import annotations

import ast
import subprocess
import sys

from portbench.harness import spec as S

PROBE = """
import ctypes, sys
sys.path.insert(0, {root!r})
from portbench import run

class Info(ctypes.Structure):
    _fields_ = [(name, ctypes.c_size_t) for name in
                ("arena", "ordblks", "smblks", "hblks", "hblkhd", "usmblks", "fsmblks", "uordblks", "fordblks",
                 "keepcost")]

libc = ctypes.CDLL("libc.so.6")
libc.mallinfo2.restype = Info
libc.malloc.restype = ctypes.c_void_p
libc.malloc.argtypes = [ctypes.c_size_t]
libc.free.argtypes = [ctypes.c_void_p]
frame = 1920 * 1080 * 3 * 4
if {fixed}:
    assert run.steady_host_heap()
readings = []
held = libc.malloc(frame)  # the frame a server still holds while it makes the next
for _ in range(6):
    new = libc.malloc(frame)
    info = libc.mallinfo2()
    readings.append((info.hblkhd >= frame, info.arena))
    libc.free(held)
    held = new
print(readings)
"""


def _frames(fixed: bool) -> list:
    """(mapped anew, heap bytes) as each of six frames is allocated, the one before it still held."""
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(S.ROOT), fixed=fixed)], capture_output=True,
                         text=True, timeout=120, check=True)
    return ast.literal_eval(out.stdout.strip().splitlines()[-1])


def test_glibc_alone_maps_the_first_frames_anew():
    assert _frames(fixed=False)[0][0]


def test_under_the_fixed_policy_every_frame_comes_from_a_heap_that_never_shrinks():
    readings = _frames(fixed=True)
    assert not any(mapped for mapped, _ in readings)
    heap = [size for _, size in readings]
    assert heap == sorted(heap) and heap[0] >= 2 * 1920 * 1080 * 3 * 4
