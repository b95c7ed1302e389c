"""The port's decode step is capturable: what a CUDA graph of one step needs.

`launch.serve.CapturedDecode` captures one greedy decode step on the card
and replays it per token, as the reference jits `decode_step` once and calls
it per token.  A replay re-runs the captured kernels on the same tensors, so
the step must read no device value on the host, build no tensor from host
data, give every op a shape that does not depend on values, keep every cache
leaf's storage from step to step, and hold the position as a device tensor.
These tests pin each of those on the CPU, block kind by block kind, on
scaled-down configs (f32): under a dispatch mode that fails on a host read;
the identity and `data_ptr()` of every cache leaf across three steps; the
0-d int32 `pos` against JAX's after prefill and each step; the eager loop's
tokens (`serve_requests(graph=False)`) against `repro.launch.serve`'s; and
the errors of a graph asked for off the card.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401

from _torch_parity import both_params, flatten  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import decode_step, prefill  # noqa: E402
from repro_torch.models.model import greedy  # noqa: E402

MODEL_TOL = {"atol": 2e-3, "rtol": 2e-3}   # tests/test_models_smoke.py's bound
PROMPT, STEPS, BATCH = 12, 3, 2

# one arch a block kind, 2 layers where its pattern has one kind (a whole
# period otherwise); gemma3-4b's window cut to 8 so that its local layers'
# ring wraps in prefill and again in decode
KINDS = {"attn": ("stablelm-3b", {"num_layers": 2}),
         "local": ("gemma3-4b", {"window": 8}),
         "mla": ("minicpm3-4b", {"num_layers": 2}),
         "rglru": ("recurrentgemma-9b", {"num_layers": 3}),
         "rwkv6": ("rwkv6-3b", {"num_layers": 2}),
         "moe": ("qwen3-moe-235b-a22b", {"num_layers": 2}),
         "cross": ("whisper-base", {"num_layers": 2})}
_MODELS: dict = {}


def _cfg(arch, **cuts):
    return dataclasses.replace(jax_configs.get(arch).scaled_down(), dtype="float32",
                               remat=False, **cuts)


def _model(kind):
    """(JAX config, JAX params, the port's model with the same weights) of
    `kind`'s arch, drawn once a test process."""
    if kind not in _MODELS:
        arch, cuts = KINDS[kind]
        cfg = _cfg(arch, **cuts)
        _MODELS[kind] = (cfg, *both_params(cfg))
    return _MODELS[kind]


def _batch(cfg, seq=PROMPT, seed=0):
    """numpy tokens (B, seq) and, for whisper, frames (B, encoder_seq, d)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, seq)).astype(np.int32)}
    if cfg.enc_dec:
        out["frames"] = rng.standard_normal((BATCH, cfg.encoder_seq, cfg.d_model),
                                            dtype=np.float32)
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


_LIFT = torch.ops.aten.lift_fresh.default
_INDEX = torch.ops.aten.index.Tensor


class NoHostReads(TorchDispatchMode):
    """Fails on what a captured step cannot do: read a device value on the
    host (`aten._local_scalar_dense`, `aten.item`: `.item()`, `int(t)`,
    `bool(t)`), build a tensor from host data (`aten.lift_fresh`:
    `torch.tensor`, `torch.as_tensor` of a Python number), or run an op whose
    output shape depends on values (`nonzero`, `masked_select`, boolean-mask
    indexing, `one_hot`); indexing by integer tensors has its index's shape
    and passes.  A CPU tensor's `.tolist()` and `.cpu()` read its memory
    without an op, so they are not seen here: on the card the capture itself
    refuses them."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        bad = None
        if torch.Tag.data_dependent_output in func.tags:
            bad = "reads a device value on the host"
        elif func is _LIFT:
            bad = "builds a tensor from host data"
        elif torch.Tag.dynamic_output_shape in func.tags:
            masks = func is _INDEX and any(
                t is not None and t.dtype in (torch.bool, torch.uint8) for t in args[1])
            if func is not _INDEX or masks:
                bad = "has an output shape that depends on values"
        if bad:
            raise AssertionError(f"{func} {bad}")
        return func(*args, **kwargs)


def test_the_mode_catches_each_kind_of_host_read():
    """The dispatch mode itself: each forbidden op raises, integer indexing
    and in-place index writes pass."""
    t = torch.arange(6.0)
    for fn in (lambda: t[2].item(), lambda: int(t[1]), lambda: bool(t[0] > 1),
               lambda: torch.nonzero(t), lambda: t[t > 2], lambda: torch.tensor([1, 2]),
               lambda: torch.as_tensor(0.5),
               lambda: torch.nn.functional.one_hot(torch.arange(3), 4)):
        with pytest.raises(AssertionError), NoHostReads():
            fn()
    with NoHostReads():
        t[torch.arange(2)]
        t.index_copy_(0, torch.zeros(1, dtype=torch.long), t[:1] + 1)


@pytest.mark.parametrize("kind", list(KINDS))
def test_decode_step_and_greedy_read_nothing_on_the_host(kind):
    """One `decode_step` + `greedy` of each block kind (attention, a local
    layer's wrapped ring, MLA's absorbed decode, RG-LRU, RWKV-6, a MoE FFN,
    whisper's cross attention) under `NoHostReads`: no host read, no tensor
    from host data, no value-dependent shape."""
    cfg, _, model = _model(kind)
    batch = _torch_batch(_batch(cfg))
    with torch.inference_mode():
        logits, caches = prefill(model.cfg, model, batch, max_seq=PROMPT + STEPS + 1,
                                 logits_whole=False)
        tok = greedy(model.cfg, model, logits)[:, None]
        with NoHostReads():
            logits, caches = decode_step(model.cfg, model, tok, caches, logits_whole=False)
            tok = greedy(model.cfg, model, logits)[:, None]
    assert tok.shape == (BATCH, 1) and torch.isfinite(logits).all()


def _leaves(caches):
    """[(name, tensor)] of every cache leaf, in a fixed order."""
    out = []
    for i, c in enumerate(caches):
        for k, v in c.items():
            items = v.items() if isinstance(v, dict) else [("", v)]
            out += [(f"{i}.{k}.{j}".rstrip("."), t) for j, t in items]
    return out


def _jax_positions(jcache) -> set:
    return {int(x) for key, a in flatten(jcache).items() if key.endswith("/pos")
            for x in np.asarray(a).ravel()}


@pytest.mark.parametrize("kind", list(KINDS))
def test_every_cache_leaf_is_written_in_place(kind):
    """Across three decode steps every tensor of every cache dict is the same
    object with the same storage; `pos` is a 0-d int32 tensor equal to JAX's
    after prefill and after each step (each attention or MLA layer's, all
    equal), and the logits are JAX's at the models' bound."""
    cfg, jp, model = _model(kind)
    nb = _batch(cfg, PROMPT + STEPS)
    prompt = {k: (v[:, :PROMPT] if k == "tokens" else v) for k, v in nb.items()}
    max_seq = PROMPT + STEPS + 1
    _, jc = jax_prefill(cfg, jp, {k: jnp.asarray(v) for k, v in prompt.items()},
                        max_seq=max_seq)
    with torch.inference_mode():
        _, caches = prefill(model.cfg, model, _torch_batch(prompt), max_seq=max_seq)
        held = [(name, t, t.data_ptr()) for name, t in _leaves(caches)]
        pos = [t for name, t, _ in held if name.endswith(".pos")]
        assert len(pos) == (0 if kind == "rwkv6" else
                            sum(k in ("attn", "local", "mla") for k in cfg.layer_kinds))
        for t in pos:
            assert t.dim() == 0 and t.dtype == torch.int32
        want = _jax_positions(jc)
        assert {int(t) for t in pos} == want
        for s in range(STEPS):
            tok = nb["tokens"][:, PROMPT + s:PROMPT + s + 1]
            wl, jc = jax_decode_step(cfg, jp, jnp.asarray(tok), jc)
            got, caches = decode_step(model.cfg, model, torch.from_numpy(tok), caches)
            np.testing.assert_allclose(got.numpy(), np.asarray(wl), err_msg=f"step {s}",
                                       **MODEL_TOL)
            now = _leaves(caches)
            assert [name for name, _ in now] == [name for name, _, _ in held]
            for (name, t), (_, t0, ptr) in zip(now, held, strict=True):
                assert t is t0 and t.data_ptr() == ptr, f"{name} rebound at step {s}"
            assert {int(t) for t in pos} == _jax_positions(jc) == {p + s + 1 for p in want}


def _requests(mod, cfg, P, N, B, seed=3):
    """tests/test_torch_serve.py's requests: per-request budgets N - 2, N."""
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, P).astype(np.int32),
                        max_new_tokens=N if i else N - 2)
            for i in range(B)]


@pytest.mark.parametrize("kind", ["attn", "local", "rwkv6", "mla"])
def test_eager_loop_gives_the_references_tokens(kind):
    """`serve_requests(graph=False)`, the step the graph captures run
    eagerly, against `repro.launch.serve` on the serve tests' inputs: a
    dense, a windowed (its ring wrapping), a recurrent and an MLA arch."""
    cfg, jp, model = _model(kind)
    P, N, B = 12, 5, 3
    want = jax_serve.serve_requests(cfg, jp, _requests(jax_serve, cfg, P, N, B),
                                    max_seq=P + N + 1, progress=lambda *_: None)
    lines = []
    got = serve.serve_requests(model.cfg, model, _requests(serve, cfg, P, N, B),
                               max_seq=P + N + 1, progress=lines.append, device="cpu",
                               graph=False)
    assert got == want
    assert lines[1].endswith(", eager")


def test_graph_off_the_card_raises():
    """No CUDA graph on the CPU: `graph=True` raises ValueError, and so does
    a `decode_loop` with a graph or a `CapturedDecode` of a CPU step; the
    default there is the eager loop."""
    cfg, _, model = _model("attn")
    reqs = _requests(serve, cfg, 6, 3, 2)
    with pytest.raises(ValueError, match="graph=True needs a CUDA device"):
        serve.serve_requests(model.cfg, model, reqs, max_seq=10, progress=lambda *_: None,
                             device="cpu", graph=True)
    with torch.inference_mode():
        tokens = torch.zeros((2, 6), dtype=torch.int32)
        logits, caches = prefill(model.cfg, model, {"tokens": tokens}, max_seq=10)
        tok = greedy(model.cfg, model, logits)[:, None]
        with pytest.raises(ValueError, match="on the card"):
            serve.CapturedDecode(model.cfg, model, caches, tok)
        with pytest.raises(ValueError, match="on the card"):
            serve.decode_loop(model.cfg, model, caches, tok, [3, 3], graph=True,
                              progress=lambda *_: None)
    lines = []
    got = serve.serve_requests(model.cfg, model, _requests(serve, cfg, 6, 3, 2), max_seq=10,
                               progress=lines.append, device="cpu")
    assert lines[1].endswith(", eager") and all(len(t) for t in got.values())
