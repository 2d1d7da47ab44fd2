"""The port's one boundary to its CUDA kernels (rtw_tpu_torch/utils/kernels.py)
on the CPU:

- `check`, the one tensor check every wrapper runs before a launch: each
  failure with its exception type, naming the plane;
- `Library.launch` on a fake library: a nonzero return raises with the
  entry point and the decoded error, a zero return counts the launch, a
  tensor off the card is refused before anything is built;
- the libraries the wrappers declare: built at the first launch, never at
  import, and each entry point and `rtw_error_string` exported by its
  source;
- `SplitTables` checked where they are made.
"""

import contextlib
import dataclasses
import re
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import rtw_tpu_torch as rtt
from rtw_tpu_torch import denoise as DN
from rtw_tpu_torch.ops import mega_kernel as MK
from rtw_tpu_torch.ops import shade_kernel as SK
from rtw_tpu_torch.ops import trace_kernel as TK
from rtw_tpu_torch.utils import kernels

CSRC = Path(__file__).resolve().parent.parent / "rtw_tpu_torch" / "csrc"
LIBRARIES = (TK.LIB, SK.LIB, MK.LIB, DN.LIB)
CPU = torch.device("cpu")


def _plane():
    return torch.zeros((4, 6), dtype=torch.float32)


# (fault, plane, exception): each way a plane fails the check
FAULTS = [
    ("not_a_tensor", [[0.0] * 6] * 4, TypeError),
    ("device", _plane().to("meta"), ValueError),
    ("dtype", _plane().double(), TypeError),
    ("shape", _plane()[:3], ValueError),
    ("strides", _plane().t().contiguous().t(), ValueError),
]


@pytest.mark.parametrize("fault,plane,err", FAULTS,
                         ids=[f for f, _, _ in FAULTS])
def test_check_refuses_each_fault_naming_the_plane(fault, plane, err):
    good = ("good", _plane(), torch.float32, (4, 6))
    with pytest.raises(err, match=r"^who: bad "):
        kernels.check("who", CPU, [good, ("bad", plane, torch.float32,
                                          (4, 6))])


def test_check_takes_any_shape_where_asked():
    kernels.check("who", CPU, [("a", _plane(), torch.float32, kernels.ANY),
                               ("b", torch.zeros(3, dtype=torch.int32),
                                torch.int32, (3,))])
    with pytest.raises(ValueError, match="strides|contiguous"):
        kernels.check("who", CPU, [("a", _plane().t(), torch.float32,
                                    kernels.ANY)])


class _FakeDll:
    """A library whose entry point returns the code it is handed."""

    def __init__(self):
        self.calls = []

    def rtw_fake(self, code, stream):
        self.calls.append((code, stream))
        return code

    @staticmethod
    def rtw_error_string(code):
        return f"fake error {code}".encode()


@pytest.fixture
def fake(monkeypatch):
    """A Library filled with `_FakeDll`, and torch.cuda's device guard and
    stream stubbed for a card this machine does not have."""
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: SimpleNamespace(cuda_stream=1234))
    lib = kernels.Library("fake", {"rtw_fake": []})
    lib._dll = _FakeDll()
    return lib


def test_launch_counts_a_zero_return(fake):
    kernels.launches.clear()
    fake.launch("rtw_fake", torch.device("cuda", 0), 0)
    fake.launch("rtw_fake", torch.device("cuda", 0), 0)
    assert kernels.launches["rtw_fake"] == 2
    assert fake._dll.calls == [(0, 1234), (0, 1234)]   # the stream last


def test_launch_raises_on_a_nonzero_return(fake):
    kernels.launches.clear()
    with pytest.raises(RuntimeError,
                       match=r"rtw_fake kernel launch failed: fake error 7"):
        fake.launch("rtw_fake", torch.device("cuda", 0), 7)
    assert kernels.launches["rtw_fake"] == 0


def test_launch_refuses_a_device_off_the_card():
    lib = kernels.Library("no_such_source", {"rtw_fake": []})
    with pytest.raises(ValueError, match="CUDA"):
        lib.launch("rtw_fake", CPU)
    assert lib._dll is None                 # nothing built or loaded


@pytest.mark.parametrize("lib", LIBRARIES, ids=[lb.name for lb in LIBRARIES])
def test_each_library_is_declared_not_loaded_and_exported(lib):
    """Loading waits for the first launch; the source exports every entry
    point the wrapper declares, each returning an int, and the shared
    error decoder."""
    assert lib._dll is None
    src = (CSRC / f"{lib.name}.cu").read_text()
    for entry in lib.entry_points:
        assert re.search(rf'extern "C" int {entry}\(', src), entry
    assert 'extern "C" const char* rtw_error_string(int code)' in src


def test_every_kernel_source_has_a_library():
    assert sorted(p.stem for p in CSRC.glob("*.cu")) == sorted(
        lb.name for lb in LIBRARIES)


@pytest.mark.parametrize("field,bad,err", [
    ("props", lambda t: t.props[:10], ValueError),
    ("plan", lambda t: t.plan.long(), TypeError),
    ("aabbs", lambda t: t.aabbs[:-1], ValueError),
    ("hier", lambda t: t.hier[:, :-1], ValueError),
    ("vol_slot", lambda t: t.vol_slot[1:], ValueError),
    ("n_blocks", lambda t: t.n_blocks + 1, ValueError),
    ("chunk_plan", lambda t: ((0, 8, 8, 99, 0, False, 8),), ValueError),
])
def test_split_tables_are_checked_where_they_are_made(field, bad, err):
    tables = TK.split_tables(rtt.build_scene(1, 16, 16, device="cpu"))
    with pytest.raises(err):
        dataclasses.replace(tables, **{field: bad(tables)})
