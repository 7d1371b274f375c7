"""The utilities of the PyTorch port against the JAX package's on the
CPU: ``Registry`` (tests/test_utils.py's semantics), ``Timer`` under a
replayed clock, ``mkdir`` and ``find_contours`` (cv2's, through both
packages' shims)."""

import numpy as np
import pytest

from paa_tpu.utils import misc as jmisc
from paa_tpu.utils import timer as jtimer
from paa_tpu.utils.registry import Registry as JRegistry
from paa_tpu_torch.utils import misc, timer
from paa_tpu_torch.utils.registry import Registry


@pytest.mark.parametrize("cls", [Registry, JRegistry])
def test_registry(cls):
    r = cls()

    @r.register("a")
    def fn_a():
        return 1

    assert r.register("b", lambda: 2)() == 2
    assert r["a"]() == 1 and r["b"]() == 2
    assert fn_a() == 1 and isinstance(r, dict) and sorted(r) == ["a", "b"]
    with pytest.raises(AssertionError):
        r.register("a", lambda: 3)
    with pytest.raises(AssertionError):
        r.register("b")(lambda: 4)
    assert cls({"c": 3})["c"] == 3


def test_timer_matches_jax(monkeypatch):
    """tic/toc pairs on a replayed clock: the same diffs, averages,
    strings and reset in both packages."""
    clock = iter([10.0, 10.5, 20.0, 21.25, 30.0, 33.0] * 2)
    for module in (timer, jtimer):
        monkeypatch.setattr(module.time, "time", lambda: next(clock))
    out = []
    for cls in (timer.Timer, jtimer.Timer):
        t = cls()
        assert t.average_time == 0.0
        t.tic()
        first = t.toc()
        t.tic()
        second = t.toc(average=False)
        t.tic()
        t.toc()
        out.append((first, second, t.calls, t.total_time, t.average_time,
                    t.avg_time_str()))
        t.reset()
        assert (t.calls, t.total_time, t.diff) == (0, 0.0, 0.0)
    assert out[0] == out[1]
    assert out[0][:5] == (0.5, 1.25, 3, 4.75, 4.75 / 3)
    assert timer.get_time_str(3725.5) == jtimer.get_time_str(3725.5) == \
        "1:02:05.500000"


def test_mkdir(tmp_path):
    path = tmp_path / "a" / "b"
    misc.mkdir(str(path))
    misc.mkdir(str(path))  # exists: no error
    assert path.is_dir()


def test_find_contours_matches_jax():
    """Two blobs and a hole: cv2's external contours, as the JAX
    package's shim returns them."""
    mask = np.zeros((40, 60), np.uint8)
    mask[5:20, 5:25] = 1
    mask[10:15, 10:15] = 0
    mask[25:38, 30:55] = 1
    got, got_h = misc.find_contours(mask.copy())
    want, want_h = jmisc.find_contours(mask.copy())
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got_h, want_h)
