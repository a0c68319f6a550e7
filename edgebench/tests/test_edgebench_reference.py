"""Each plain reference against the port's CPU path at the port's reduced
sizes, for every version and a cut at each layer boundary; and the control,
which the comparison has to fail. The test imports both; the reference
imports nothing of the port."""
import pytest
import torch

from edgebench import check, harness, reference
from edgebench.tests.small import small_config

CONFIGS = ("starcoder2-3b", "falcon-mamba-7b")
VERSIONS = ("bf16", "w8", "w4")


@pytest.fixture(scope="module", params=CONFIGS)
def served(request):
    from repro_torch.serving import SplitServingEngine

    torch.set_num_threads(2)
    config = small_config(request.param)
    cfg = harness.port_config(config, override=True)
    model = harness.build_model(cfg, config, 2 ** 31 + 7, "cpu")
    engine = SplitServingEngine(cfg, model, versions=VERSIONS, device="cpu")
    tokens = torch.randint(0, config["model"]["vocab_size"], (2, 37),
                           generator=torch.Generator().manual_seed(1))
    return config, engine, tokens


def _reqs(tokens, version, cut):
    return [{"tokens": tokens[r], "version": version, "cut": cut} for r in range(tokens.shape[0])]


@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("cut", (1, 2))
def test_reference_matches_the_port(served, version, cut):
    config, engine, tokens = served
    logits, act_bytes = engine.infer({"tokens": tokens}, ("main", cut), version)
    want = reference.logits(config, 2 ** 31 + 7, _reqs(tokens, version, cut), "cpu")
    for r in range(tokens.shape[0]):
        # f32 on both sides, different summation orders: a few ulps of the
        # logits' scale; no int8 code flips at these sizes
        assert check.logit_err(logits[r], want[r]) < 1e-5
    assert act_bytes == check.link_bytes(config, 2, 37, version)


@pytest.mark.parametrize("version", VERSIONS)
def test_control_fails_where_the_port_passes(served, version):
    config, engine, tokens = served
    logits, _ = engine.infer({"tokens": tokens}, ("main", 1), version)
    reqs = _reqs(tokens, version, 1)
    want = reference.logits(config, 2 ** 31 + 7, reqs, "cpu")
    ctl = reference.logits(config, 2 ** 31 + 7, reqs, "cpu", control=True)
    port = max(check.logit_err(logits[r], want[r]) for r in range(2))
    control = min(check.logit_err(ctl[r], want[r]) for r in range(2))
    assert control > 100 * port


def test_tf32_rounding():
    from edgebench.reference.arith import tf32_round

    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -1.0 - 2 ** -12, 3.0])
    want = torch.tensor([1.0, 1.0, 1.0 + 4 * 2 ** -11, -1.0, 3.0])
    assert torch.equal(tf32_round(x), want)


def test_w8a8_is_exact_integer_arithmetic():
    from edgebench.reference.arith import Arith, quantize_rows

    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(5, 64, generator=g), torch.randn(64, 3, generator=g)
    xq, xs = quantize_rows(x, 127)
    assert xq.abs().max() == 127 and torch.equal(xq, xq.round())
    got = Arith().w8a8(x, w)
    wq = torch.clamp(torch.round(w / (w.abs().amax(0) / 127)), -127, 127)
    ws = w.abs().amax(0) / 127
    want = (xq.double() @ wq.double()).float() * xs * ws
    assert torch.allclose(got, want, rtol=1e-6, atol=1e-6)


def test_widest_and_median_position_errors():
    """``logit_err`` is the widest position's gap and ``logit_med`` the
    median position's, each over the position's rms of the reference."""
    want = torch.ones(5, 4)
    got = want + torch.tensor([0.0, 0.1, 0.2, 0.3, 4.0])[:, None]
    errs = check.position_errs(got, want)
    assert torch.allclose(errs, torch.tensor([0.0, 0.1, 0.2, 0.3, 4.0]))
    assert check.logit_err(got, want) == pytest.approx(4.0)
    assert float(errs.median()) == pytest.approx(0.2)
    bad = got.clone()
    bad[2, 1] = float("nan")
    assert torch.isinf(check.position_errs(bad, want)).all()


def test_tf32_control_keeps_the_int8_codes():
    from edgebench.reference.arith import Arith

    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(5, 64, generator=g), torch.randn(64, 3, generator=g)
    assert torch.equal(Arith("control_tf32").w8a8(x, w), Arith().w8a8(x, w))
    assert not torch.equal(Arith("control").w8a8(x, w), Arith().w8a8(x, w))
    assert not torch.equal(Arith("control_tf32").mm(x, w), Arith().mm(x, w))


def test_attention_tf32_control_rounds_only_the_attention():
    from edgebench.reference.arith import Arith, tf32_round

    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(5, 64, generator=g), torch.randn(64, 3, generator=g)
    ar = Arith("control_attn_tf32")
    assert torch.equal(ar.mm(x, w), Arith().mm(x, w))
    assert torch.equal(ar.w8a8(x, w), Arith().w8a8(x, w))
    assert torch.equal(ar.einsum("ik,kj->ij", x, w),
                       torch.einsum("ik,kj->ij", tf32_round(x), tf32_round(w)))
