"""What lets the port's train step be captured as a CUDA graph, on the CPU:
the step's body (forward, loss, backward, clip + AdamW, write-back, EMA)
makes no tensor from host data and waits on nothing, on the WebP, JPEG,
AVIF and unified MINI models with dropout and the EMA on; the step's f32
scalars (learning rate, bias corrections, the EMA's decay) are optax's and
the JAX step's f32 values; the signature tells apart what a captured step
is specific to; and the graph path is never taken on CPU tensors, over a
mesh or on a model whose forward holds collectives (block remat takes
it). The capture and replay themselves run on the card
(tests/test_torch_kernels_cuda.py); three port steps against three jitted
JAX steps are in tests/test_torch_train.py."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddpm_image_restoration_tpu.train.schedules import cosine_warm_restarts as j_schedule
from ddpm_image_restoration_tpu_torch.config import ModelConfig, TrainConfig, codec_index
from ddpm_image_restoration_tpu_torch.diffusion import losses
from ddpm_image_restoration_tpu_torch.models import build_model
from ddpm_image_restoration_tpu_torch.train import steps
from tests._tiny import MINI
from tests._torch_parity import smooth_images
from tests.test_torch_graph import _NoHostData, _no_from_numpy

torch.set_num_threads(1)

PRESETS = ("webp", "jpeg", "avif", "all")


def _setup(codec: str, seed: int = 0, **model_kw):
    """A MINI model of `codec` (dropout 0.1, f32), its train state with the
    EMA on, its step, and a batch of 2 (the unified model's with a
    per-sample `codec_id`)."""
    torch.manual_seed(seed)
    mcfg = ModelConfig(**{**dataclasses.asdict(MINI), **model_kw})
    model = build_model(codec, mcfg, device="cpu")
    cfg = TrainConfig(codec=codec, model=mcfg, ema_decay=0.999)
    x0 = torch.from_numpy(smooth_images(2, MINI.image_size, seed=3))
    xt = (x0 + 0.1 * torch.randn(x0.shape, generator=torch.Generator().manual_seed(4))).clamp(-1, 1)
    batch = {"x0": x0, "xt": xt, "t": torch.tensor([17, 64], dtype=torch.int32)}
    if codec == "all":
        batch["codec_id"] = torch.tensor([codec_index("jpeg"), codec_index("avif")])
    return model, cfg, steps.create_train_state(model, cfg), batch


def _guarded_body(monkeypatch, entered: list):
    """Run `_step_body` under `_NoHostData` (torch.from_numpy replaced too)."""
    body = steps._step_body

    def guarded(*a, **k):
        entered.append(True)
        with pytest.MonkeyPatch.context() as mp, _NoHostData():
            mp.setattr(torch, "from_numpy", _no_from_numpy)
            return body(*a, **k)

    monkeypatch.setattr(steps, "_step_body", guarded)


@pytest.mark.parametrize("codec", PRESETS)
def test_step_body_makes_no_tensor_from_host_data(monkeypatch, codec):
    """Two steps of each preset's loss (frequency_aware, avif_frequency_aware,
    color_preservation; the unified model conditioned per sample), dropout
    0.1 and the EMA on: the body under `_NoHostData` gives, bit for bit,
    the loss, grad norm, masters, moments and EMA of the same steps run
    without it from the same weights and generator (the first call fills
    the device-constant caches, as a signature's eager first call does on
    the card)."""
    runs = []
    for guard in (False, True):
        model, cfg, state, batch = _setup(codec)
        step, gen = steps.make_train_step(model, cfg), torch.Generator().manual_seed(1)
        entered = []
        if guard:
            _guarded_body(monkeypatch, entered)
        metrics = [step(state, batch, gen) for _ in range(2)]
        assert entered == ([True, True] if guard else [])
        runs.append((metrics, state))
    (want, s0), (got, s1) = runs
    for w, g in zip(want, got):
        assert torch.equal(w["loss"], g["loss"]) and torch.equal(w["grad_norm"], g["grad_norm"])
    for part in ("params", "mu", "nu", "ema"):
        for k, v in getattr(s0, part).items():
            assert torch.equal(v, getattr(s1, part)[k]), (part, k)
    assert s1.step == 2


def test_no_host_data_mode_catches_the_old_ssim_bands(monkeypatch):
    """The check above fails on the SSIM filter the loss used to run, which
    copied its two band matrices from the host on every call."""
    def old_filter(x):
        h, w = x.shape[-2:]
        band_h = torch.as_tensor(losses._gaussian_band(h), device=x.device)
        band_w = torch.as_tensor(losses._gaussian_band(w), device=x.device)
        return torch.matmul(torch.matmul(band_h, x), band_w.T)

    model, cfg, state, batch = _setup("webp")
    step = steps.make_train_step(model, cfg)
    step(state, batch, torch.Generator().manual_seed(1))
    monkeypatch.setattr(losses, "_gaussian_filter", old_filter)
    _guarded_body(monkeypatch, [])
    with pytest.raises(AssertionError, match="host data"):
        step(state, batch, torch.Generator().manual_seed(1))


def _jax_f32(fn, count: int) -> np.float32:
    return np.float32(jax.jit(fn)(jnp.asarray(count, jnp.int32)))


@pytest.mark.parametrize("t0", [3, 100])
def test_step_scalars_equal_optax_f32(t0):
    """[lr, 1 − b1^n, 1 − b2^n, d, 1 − d] at counts 0, 1, 2 and the cosine
    segment boundaries t0 and 3·t0 equal, bit for bit, what the jitted JAX
    step computes in f32: the JAX package's schedule at the count (optax's
    joined cosine segments), optax's `1 - decay**count_inc`, and the EMA's
    min(decay, (1 + t)/(10 + t)) at the incremented step t. At every count
    below 4·t0 the learning rate is within 2^-21 of the base rate of the
    schedule's (4 f32 steps of the base rate; 1.5e-7 of it measured): the
    cosine is rounded once from its f64 value where XLA computes it in f32,
    and near the end of a segment, where 1 + cos cancels, an ulp of the
    cosine is many of the rate's."""
    base, decay = 2e-4, 0.999
    cfg = TrainConfig(codec="webp", model=ModelConfig(**dataclasses.asdict(MINI)),
                      lr_override=base, cosine_t0=t0, ema_decay=decay)
    tx, j_lr = steps.make_optimizer(cfg), j_schedule(base, t0, cfg.cosine_t_mult)
    b1, b2 = cfg.betas

    def ema_d(t):
        t = t.astype(jnp.float32)
        return jnp.minimum(decay, (1.0 + t) / (10.0 + t))

    for count in (0, 1, 2, t0, 3 * t0):
        n = count + 1
        want = np.array([_jax_f32(j_lr, count), _jax_f32(lambda c: 1 - b1 ** c, n),
                         _jax_f32(lambda c: 1 - b2 ** c, n), _jax_f32(ema_d, n),
                         _jax_f32(lambda c: 1.0 - ema_d(c), n)], np.float32)
        got = steps.step_scalars(tx, count, decay)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=f"count {count}")
    counts = np.arange(4 * t0)
    want = np.asarray(jax.jit(jax.vmap(j_lr))(jnp.asarray(counts, jnp.int32)))
    got = np.array([tx.schedule(int(c)) for c in counts], np.float32)
    assert np.abs(got - want).max() <= 2.0 ** -21 * base
    assert tx.schedule(t0) == tx.schedule(0) == np.float32(base)


def _key(state, batch, gen, cfg):
    state.load_scalars(cfg.ema_decay)
    return steps._signature(state, batch, gen, cfg)


def test_signature_tells_apart_what_a_graph_is_specific_to():
    """Keys differ with the model, a reassigned parameter, a replaced
    master, moment or EMA tensor (a resume that loads new tensors), the EMA
    on or off, the batch's keys (`codec_id`), shapes and dtypes, the
    compute dtype, block remat, the dropout rate, the generator, the TF32
    flags and training mode; they match for another batch of the same shapes and
    after an in-place update of any of those tensors (the graph reads them
    by address). The loss is the step function's own (`cfg` is closed
    over), and so is its cache of graphs."""
    model, cfg, state, batch = _setup("webp")
    model.train()  # as the step sets it before computing the key
    gen = torch.Generator().manual_seed(1)
    k = _key(state, batch, gen, cfg)
    other = {n: v + 1 for n, v in batch.items()}
    assert _key(state, other, gen, cfg) == k
    with torch.no_grad():
        for part in ("params", "mu", "nu", "ema"):
            next(iter(getattr(state, part).values())).add_(1.0)
        model.out_conv.weight.mul_(1.5)
    assert _key(state, batch, gen, cfg) == k

    def differs(**changes):
        assert _key(changes.get("state", state), changes.get("batch", batch),
                    changes.get("gen", gen), cfg) != k

    differs(batch={**batch, "codec_id": torch.tensor([0, 1])})
    differs(batch={n: v[:1] for n, v in batch.items()})
    differs(batch={**batch, "xt": batch["xt"].double()})
    differs(gen=torch.Generator().manual_seed(1))
    assert steps.make_train_step(model, cfg).cache is not steps.make_train_step(model, cfg).cache
    for part in ("params", "mu", "nu", "ema"):
        d = getattr(state, part)
        name, saved = next(iter(d.items()))
        d[name] = saved.clone()
        differs()
        d[name] = saved
    saved_ema = state.ema
    state.ema = None
    differs()
    state.ema = saved_ema
    assert _key(state, batch, gen, cfg) == k
    for field, value in (("compute_dtype", "bfloat16"), ("dropout", 0.2), ("remat", True)):
        saved_cfg = model.cfg
        model.cfg = dataclasses.replace(saved_cfg, **{field: value})
        differs()
        model.cfg = saved_cfg
    for flags in (torch.backends.cudnn, torch.backends.cuda.matmul):
        flags.allow_tf32 = not flags.allow_tf32
        differs()
        flags.allow_tf32 = not flags.allow_tf32
    model.eval()
    differs()
    model.train()
    model.out_conv.weight = torch.nn.Parameter(model.out_conv.weight.detach().clone())
    differs()
    other_model, _, other_state, _ = _setup("webp")
    differs(state=dataclasses.replace(state, model=other_model))
    assert _key(state, batch, gen, cfg) != _key(other_state, batch, gen, cfg)


def test_graph_path_only_for_cuda_one_process_without_remat(monkeypatch):
    """`_graphed` holds for a CUDA batch in one process, with block remat
    too (its regions draw nothing); not over a mesh (a layout), on a
    spatially split or column-parallel model, or on CPU tensors. A CPU run
    never computes a signature and keeps no graph."""
    model, cfg, state, batch = _setup("webp")
    cuda_batch = {"xt": types.SimpleNamespace(is_cuda=True)}
    assert steps._graphed(state, cuda_batch)
    assert not steps._graphed(state, batch)
    state.layout = object()
    assert not steps._graphed(state, cuda_batch)
    state.layout = None
    model.down1.column_parallel = True
    assert not steps._graphed(state, cuda_batch)
    del model.down1.column_parallel
    model.spatial_mesh = object()
    assert not steps._graphed(state, cuda_batch)
    model.spatial_mesh = None
    assert steps._graphed(state, cuda_batch)
    remat_model, _, remat_state, _ = _setup("webp", remat=True)
    assert steps._graphed(remat_state, cuda_batch)

    def no_signature(*a, **k):
        raise AssertionError("a signature computed for a CPU run")

    monkeypatch.setattr(steps, "_signature", no_signature)
    step, gen = steps.make_train_step(model, cfg), torch.Generator().manual_seed(1)
    losses_ = [step(state, batch, gen)["loss"].item() for _ in range(3)]
    assert not step.graphs and state.step == 3 and len(set(losses_)) == 3


def test_graph_cache_policy(monkeypatch):
    """`utils/graphs.py GraphCache`, the policy the sampler and the train
    step share, with the capture replaced by a stand-in: a signature's
    first call runs the body eager, its second captures and replays, later
    calls replay; at most `size` graphs, the least recently replayed
    dropped before a new capture; seen signatures bounded by
    SEEN_SIGNATURES; `captures` counts the captures made."""
    from ddpm_image_restoration_tpu_torch.utils import graphs

    class StandIn:
        def __init__(self, body, inputs, pool, generators, after):
            self.body, self.replays = body, 0

        def replay(self, inputs):
            self.replays += 1
            return tuple(self.body(*inputs))

    monkeypatch.setattr(graphs, "CapturedGraph", StandIn)
    monkeypatch.setattr(graphs, "SEEN_SIGNATURES", 3)
    cache = graphs.GraphCache(2)
    x = torch.ones(1)
    assert cache("a", lambda v: (v + 1,), [x]) == (x + 1,)
    assert not cache.graphs and list(cache.seen) == ["a"]
    cache("a", lambda v: (v,), [x])
    assert list(cache.graphs) == ["a"] and cache.captures == 1
    cache("a", lambda v: (v,), [x])
    assert cache.graphs["a"].replays == 2 and cache.captures == 1
    for key in ("b", "b", "a", "c", "c"):
        cache(key, lambda v: (v,), [x])
    assert list(cache.graphs) == ["a", "c"] and cache.captures == 3
    assert list(cache.seen) == ["a", "b", "c"]
    cache("d", lambda v: (v,), [x])
    assert list(cache.seen) == ["b", "c", "d"]
