"""flash_attention's backward kernel at MLA's head dims and its work
split, on the CPU (the plain backward at MLA's widths against ``jax.vjp``
is in tests/test_torch_train.py).

The kernel's instances in its source, (192, 128) and (48, 32) among them,
are the wrapper's. The kernel plans its own split of the dK/dV pass
(``plan_split`` in its source, checked on the card by chip_smoke.py's
phase 2); ``bwd_plan`` asks it, by the shape and the card's SM count, and
keeps its answer."""
import re
import types

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402


def test_backward_instances_in_the_source_are_the_wrappers():
    """The C entry points' instances, f32 and bf16, are BWD_HEAD_DIMS: the
    wrapper never sends a pair the kernel lacks, nor refuses one it has."""
    source = (_build.SRC_DIR / "flash_attention_bwd.cu").read_text()
    table = re.search(r"#define FA_BWD_INSTANCES\(X\)(.*?)\n\n", source, re.S).group(1)
    found = set(re.findall(r"X\((\d), [\w:]+, (\d+), (\d+)\)", table))
    want = {(str(dt), str(D), str(Dv)) for dt in (0, 1) for D, Dv in fa.BWD_HEAD_DIMS}
    assert found == want
    # both entry points, the plan and the launch, dispatch over that table
    assert source.count("FA_BWD_INSTANCES(FA_BWD_") == 2


@pytest.mark.parametrize("case", [
    ((8, 14, 2, 512, 512, 64, 64, torch.float32, True, None, 132), (0, 1, 0, 132)),
    ((4, 16, 16, 512, 512, 192, 128, torch.bfloat16, True, None, 132), (1, 1, 0, 132)),
    ((2, 14, 2, 512, 512, 64, 64, torch.float32, True, 64, 8), (0, 1, 64, 8)),
    ((1, 6, 2, 40, 100, 48, 32, torch.bfloat16, False, None, 132), (1, 0, 0, 132))])
def test_bwd_plan_asks_the_kernel_and_keeps_its_answer(monkeypatch, case):
    """``bwd_plan`` passes the shape, the dtype's code, the mask (no window
    as 0) and the SM count in the C entry point's order, returns the three
    numbers the kernel writes, and raises on the kernel's error code."""
    args, (dt, causal, window, sms) = case
    calls = []

    def plan(*a):
        calls.append(a[:-1])
        a[-1][0], a[-1][1], a[-1][2] = 19, 15, 19
        return 0
    monkeypatch.setattr(_build, "library", lambda n: types.SimpleNamespace(
        flash_attention_bwd_plan=plan) if n == "flash_attention_bwd" else None)
    fa._plan_entry.cache_clear()
    fa.bwd_plan.cache_clear()
    try:
        got = fa.bwd_plan(*args)
        assert got == fa.BwdPlan(chunk=19, slots=15, longest=19)
        assert calls == [(*args[:7], dt, causal, window, sms)]
        fa.bwd_plan(*args)            # the answer is kept: one call a shape
        assert len(calls) == 1
        monkeypatch.setattr(_build, "library", lambda n: types.SimpleNamespace(
            flash_attention_bwd_plan=lambda *a: 1))
        fa._plan_entry.cache_clear()
        fa.bwd_plan.cache_clear()
        with pytest.raises(RuntimeError, match="CUDA error 1"):
            fa.bwd_plan(*args)
    finally:
        fa._plan_entry.cache_clear()
        fa.bwd_plan.cache_clear()
