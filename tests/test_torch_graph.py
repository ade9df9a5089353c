"""What lets the port's DDRM solver loop be captured as a CUDA graph, on the
CPU: the slot loop makes no tensor from host data and waits on nothing
(on the WebP, JPEG, AVIF and unified MINI models, static and traced
budget), the device-constant caches hold what they replace bit for bit,
the signature tells apart what a captured loop is specific to, and the
graph path is never taken on CPU tensors, under grad, with remat, in the
host-codec modes or on a model whose forward holds collectives. The
capture and replay themselves run on the card
(tests/test_torch_kernels_cuda.py)."""

import dataclasses
import types

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from ddpm_image_restoration_tpu_torch.codecs import surrogate
from ddpm_image_restoration_tpu_torch.config import ModelConfig, codec_index, get_preset
from ddpm_image_restoration_tpu_torch.diffusion import ddrm
from ddpm_image_restoration_tpu_torch.models import build_model
from ddpm_image_restoration_tpu_torch.ops import dct
from tests._tiny import MINI
from tests._torch_parity import smooth_images

torch.set_num_threads(1)

# tensor methods that copy between host and device or wait on the device
_HOST_METHODS = {"cpu", "cuda", "numpy", "item", "tolist", "__bool__", "new_tensor"}


class _NoHostData(TorchFunctionMode):
    """Fails on any tensor made from host data (`torch.tensor`,
    `torch.as_tensor`, `Tensor.new_tensor`), any `.to` that names a device,
    and any copy to the host or wait on the device (`.item()`, `.cpu()`,
    truth of a tensor, ...): each is a host round trip in eager mode and
    makes a CUDA graph capture fail. (`torch.from_numpy` does not pass
    through a function mode; the test replaces it.)"""

    def __torch_function__(self, func, types_, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        names_device = "device" in kwargs or any(
            isinstance(a, (str, torch.device)) for a in args[1:])
        if (func in (torch.tensor, torch.as_tensor) or name in _HOST_METHODS
                or (name == "to" and names_device)):
            raise AssertionError(f"host data in the solver loop: {name}")
        return func(*args, **kwargs)


def _no_from_numpy(*a, **k):
    raise AssertionError("host data in the solver loop: from_numpy")


def _model(codec: str, seed: int = 0):
    torch.manual_seed(seed)
    return build_model(codec, ModelConfig(**dataclasses.asdict(MINI)), device="cpu")


@pytest.fixture(scope="module")
def models():
    return {c: _model(c, i) for i, c in enumerate(("webp", "jpeg", "avif", "all"))}


def _y(n: int = 2, seed: int = 4) -> torch.Tensor:
    return torch.from_numpy(smooth_images(n, MINI.image_size, seed=seed))


@pytest.mark.parametrize("traced_budget", [0, 4])
@pytest.mark.parametrize("model_codec,codec", [("webp", "webp"), ("jpeg", "jpeg"),
                                                ("avif", "avif"), ("all", "jpeg"),
                                                ("all", "avif")])
def test_slot_loop_makes_no_tensor_from_host_data(models, monkeypatch, model_codec, codec,
                                                  traced_budget):
    """The slot loop (`DDRMSampler._loop`, after the host set-up) under
    `_NoHostData`, with eta noise, the phase gate on, encoder reuse 2 and a
    per-sample quality; the unified model conditioned on `codec_id`. Its
    output equals the same run without the mode."""
    model = models[model_codec]
    cid = codec_index(codec) if model_codec == "all" else None
    sampler = ddrm.DDRMSampler(model, get_preset(codec), codec_id=cid)
    y, q = _y(), [10.0, 12.0]
    steps = [16, 11] if traced_budget else 21
    kw = dict(stride=5, encoder_reuse=2, traced_budget=traced_budget, eta=0.5)
    with torch.no_grad():
        want = sampler.run(y, q, steps, generator=torch.Generator().manual_seed(1), **kw)
    loop = ddrm.DDRMSampler._loop
    entered = []

    def guarded(self, *a, **k):
        entered.append(True)
        with pytest.MonkeyPatch.context() as mp, _NoHostData():
            mp.setattr(torch, "from_numpy", _no_from_numpy)
            return loop(self, *a, **k)

    monkeypatch.setattr(ddrm.DDRMSampler, "_loop", guarded)
    with torch.no_grad():
        got = sampler.run(y, q, steps, generator=torch.Generator().manual_seed(1), **kw)
    assert entered
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_no_host_data_mode_catches_the_old_host_copies():
    """The check above fails on the kinds of host copy the loop used to
    make: knots made by `torch.as_tensor`, the JPEG scale's numerator by
    `new_tensor`, a constant moved by `.to(device)`; and on a wait on the
    device (the truth of a tensor)."""
    x = torch.zeros(4)
    for bad in (lambda: torch.as_tensor([1.0, 2.0], device=x.device),
                lambda: x.new_tensor(5000.0),
                lambda: torch.ones(2).to(x.device),
                lambda: bool(x.sum() > 0)):
        with pytest.raises(AssertionError, match="host data"), _NoHostData():
            bad()


def test_device_constants_equal_what_they_replace():
    """Tables, Kronecker DCT matrices, interpolation knots and the
    low-frequency mask held on the device equal, bit for bit, the tensors
    the step used to copy from the host each call; each is made once."""
    cpu = torch.device("cpu")
    for n in (4, 8):
        k = surrogate._kron(n, torch.zeros(1))
        assert torch.equal(k, torch.from_numpy(surrogate.kron_dct_matrix(n)))
        assert surrogate._kron(n, torch.zeros(1)) is k
        assert torch.equal(surrogate._kron(n, torch.zeros(1, dtype=torch.bfloat16)),
                           torch.from_numpy(surrogate.kron_dct_matrix(n)).bfloat16())
    for codec in ("jpeg", "webp", "avif"):
        for chroma, table in enumerate(surrogate._base_tables(codec)):
            got = surrogate.device_constant(surrogate._base_table, (codec, bool(chroma)), cpu)
            assert torch.equal(got, torch.from_numpy(table))
        for xp, fp in [surrogate._CALIBRATION[codec], surrogate._DEBLOCK[codec][:2]]:
            x = torch.linspace(-5, 120, 301)
            want_xp = torch.as_tensor(xp, dtype=torch.float32)
            want_fp = torch.as_tensor(fp, dtype=torch.float32)
            i = torch.clamp(torch.searchsorted(want_xp, x, right=True), 1, len(xp) - 1)
            w = (x - want_xp[i - 1]) / (want_xp[i] - want_xp[i - 1])
            want = want_fp[i - 1] + w * (want_fp[i] - want_fp[i - 1])
            want = torch.where(x <= want_xp[0], want_fp[0], want)
            want = torch.where(x >= want_xp[-1], want_fp[-1], want)
            assert torch.equal(surrogate.interp(x, xp, fp), want)
    for q_knots, f_knots in [(ddrm._DAMAGE_Q, ddrm._DAMAGE_RMS["avif"])]:
        got = surrogate.device_constant(surrogate._knots, (tuple(q_knots.tolist()),), cpu)
        assert torch.equal(got, torch.as_tensor(q_knots, dtype=torch.float32))
    for h, w, bs, low in [(16, 16, 4, 2), (20, 12, 8, 3), (64, 64, 8, 4)]:
        want = torch.from_numpy(dct._low_freq_mask_np(h, w, bs, low))[None, None]
        assert torch.equal(dct.low_freq_mask(h, w, bs, low), want)
        assert torch.equal(dct.low_freq_mask(h, w, bs, low, dtype=torch.bfloat16),
                           want.bfloat16())


def test_scalars_reach_the_ops_unchanged():
    """A Python scalar becomes a fill on the device with the value the
    host copy gave; the JPEG quality scale's numerator too; and the
    unified model's codec embedding index."""
    for v in (0.0, 8.0, 0.3, 17, np.float32(0.45), np.float64(12.7)):
        assert torch.equal(surrogate._per_sample(v, 3, "cpu"),
                           torch.as_tensor(v, dtype=torch.float32).reshape(-1).expand(3))
    q = torch.tensor([1.0, 3.0, 7.0, 17.0, 33.0, 49.5, 50.0, 77.0])
    old = torch.where(q < 50.0, q.new_tensor(5000.0) / q, 200.0 - 2.0 * q)
    assert torch.equal(surrogate.jpeg_quality_scale(q), old)
    model = _model("all")
    t = torch.tensor([0.3, 0.7])
    for cid in (0, 2, np.int64(1)):
        want = model.time_embed(t) + model.codec_embed(
            torch.as_tensor(cid, dtype=torch.long).expand(t.shape))
        assert torch.equal(model._prep(t, None, cid)[0], want)


def _key(sampler, y, quality, steps, **kw):
    """The signature `run` computes for these arguments (the graph path
    forced on, so that the CPU run records it as a first call)."""
    sampler._cache.seen.clear()
    with torch.no_grad():
        sampler.run(y, quality, steps, **kw)
    (key,) = sampler._cache.seen
    return key


@pytest.fixture
def keyed(monkeypatch):
    monkeypatch.setattr(ddrm.DDRMSampler, "_graphed", lambda self, y, remat: True)
    return ddrm.DDRMSampler(_model("webp", 7), get_preset("webp"))


def test_signature_tells_apart_what_a_graph_is_specific_to(keyed):
    """Keys differ with the phase gate (q10 under WebP's threshold of 15,
    q40 over it, the same schedule of steps 20, 15, 10, 5, 0), rows, eta, a reassigned parameter and the
    schedule; they match for two batches of one shape at different
    qualities under the traced budget (quality is an input), and for an
    in-place weight update (the graph reads the weights by address)."""
    y, y2 = _y(), _y(seed=9)
    base = dict(stride=5, encoder_reuse=2, eta=0.0)
    k = _key(keyed, y, 10, 21, **base)
    assert _key(keyed, y2, 10, 21, **base) == k
    assert _key(keyed, y, 40, 21, **base) != k                      # phase gate off
    assert _key(keyed, y, 10, 21, rows=(0, 1), **base) != k
    assert _key(keyed, y, 10, 21, **{**base, "eta": 0.5}) != k
    assert _key(keyed, y, 10, 21, **{**base, "stride": 4}) != k
    assert _key(keyed, y[:1], 10, 21, **base) != k
    budget = dict(traced_budget=4, encoder_reuse=2, eta=0.0)
    kb = _key(keyed, y, [40.0, 60.0], [16, 11], **budget)
    assert _key(keyed, y2, [55.0, 90.0], [16, 11], **budget) == kb
    assert _key(keyed, y, [10.0, 60.0], [16, 11], **budget) != kb   # phase gate on, sample 0
    assert _key(keyed, y, [40.0, 60.0], [16, 12], **budget) != kb
    with torch.no_grad():
        keyed.model.out_conv.weight.mul_(1.5)
    assert _key(keyed, y, 10, 21, **base) == k
    keyed.model.out_conv.weight = torch.nn.Parameter(keyed.model.out_conv.weight.clone(),
                                                     requires_grad=False)
    assert _key(keyed, y, 10, 21, **base) != k


def test_graph_path_only_for_cuda_no_grad_surrogate(models, monkeypatch):
    """`_graphed` holds for a CUDA batch under no_grad in 'surrogate' mode
    without remat; not under grad, with remat, in the host-codec modes, on
    a spatially split or column-parallel model, or on CPU tensors. A CPU
    run never computes a signature."""
    cuda_y = types.SimpleNamespace(is_cuda=True)
    model = _model("webp", 3)
    s = ddrm.DDRMSampler(model, get_preset("webp"))
    with torch.no_grad():
        assert s._graphed(cuda_y, remat=False)
        assert not s._graphed(cuda_y, remat=True)
        assert not s._graphed(_y(), remat=False)
        for mode in ("callback", "host_loop"):
            assert not ddrm.DDRMSampler(model, get_preset("webp"),
                                        consistency_mode=mode)._graphed(cuda_y, remat=False)
    with torch.enable_grad():
        assert not s._graphed(cuda_y, remat=False)
    with torch.no_grad():
        model.down1.column_parallel = True
        assert not s._graphed(cuda_y, remat=False)
        del model.down1.column_parallel
        model.spatial_mesh = object()
        assert not s._graphed(cuda_y, remat=False)
        model.spatial_mesh = None
        assert s._graphed(cuda_y, remat=False)

    def no_signature(*a, **k):
        raise AssertionError("a signature computed for a CPU run")

    monkeypatch.setattr(ddrm.DDRMSampler, "_signature", no_signature)
    with torch.no_grad():
        s.sample(_y(), 10, 21, stride=5, eta=0.0, final_exact=False)
        s.sample(_y(), 10, 21, stride=5, eta=0.0, final_exact=False)
    assert not s._cache.seen and not s._cache.graphs
