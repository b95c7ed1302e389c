"""Port parity: the dry run (`repro_torch/launch/dryrun.py`) and the batch
specs (`repro_torch/data/pipeline.make_batch_specs`) vs the reference's
`repro.launch.dryrun` and `repro.data.pipeline`.

The reference's dry run sets a 512-device `XLA_FLAGS` when it is imported,
so its cells, skips, variants and errors are read in a subprocess; its
sharding rules are evaluated in process on `jax.sharding.AbstractMesh`
stand-ins (axis names and sizes, no devices), as tests/test_torch_mesh.py
does.  The port's side runs on `torch.distributed`'s fake backend under
`FakeTensorMode`: nothing is allocated and no device is touched.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401
import torch.distributed as dist  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.data.pipeline import make_batch_specs as ref_batch_specs  # noqa: E402
from repro.launch import shardings as ref_shardings  # noqa: E402
from repro.models import init_caches as jax_init_caches  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.collectives import bruck_all_to_all  # noqa: E402
from repro_torch.collectives.bruck_rs_ag import shift  # noqa: E402
from repro_torch.data import make_batch_specs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import SHAPES, ShapeConfig  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POD = AbstractMesh((16, 16), ("data", "model"))

_REFERENCE = """
import json
from repro import configs
from repro.launch import dryrun
try:
    dryrun._apply_variant(configs.get("stablelm-3b"), "baseline,no-such")
    err = None
except ValueError as e:
    err = str(e)
cells = configs.cells()
print(json.dumps({"variants": dryrun.VARIANTS, "ops": dryrun.COLLECTIVE_OPS,
                  "cells": cells, "runnable": [configs.runnable(a, s) for a, s in cells],
                  "error": err}))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REFERENCE], env=env, capture_output=True,
                         text=True, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_cells_skips_variants_and_errors_are_the_references(reference):
    cells = configs.cells()
    assert [list(c) for c in cells] == reference["cells"]
    assert len(cells) == 40
    assert [list(configs.runnable(a, s)) for a, s in cells] == reference["runnable"]
    assert list(dryrun.VARIANTS) == reference["variants"]
    assert list(dryrun.COLLECTIVE_OPS) == reference["ops"]
    with pytest.raises(ValueError) as err:
        dryrun._apply_variant(configs.get("stablelm-3b"), "baseline,no-such")
    assert str(err.value) == reference["error"]


def test_cli_prints_the_references_skips_and_rejects_a_bad_variant(tmp_path, capsys,
                                                                   reference):
    with pytest.raises(ValueError, match="unknown variant"):
        dryrun.main(["--all", "--variant", "no-such", "--out", str(tmp_path)])
    # every runnable cell already traced: the sweep only prints its lines
    for (a, s), (ok, _) in zip(reference["cells"], reference["runnable"], strict=True):
        if ok:
            for mk in ("pod", "multipod"):
                (tmp_path / f"{a}__{s}__{mk}.json").write_text("{}")
    dryrun.main(["--all", "--mesh", "both", "--out", str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    skips = [f"SKIP {a} x {s}: {why}" for (a, s), (ok, why)
             in zip(reference["cells"], reference["runnable"], strict=True) if not ok]
    assert [ln for ln in lines if ln.startswith("SKIP")] == skips
    assert len(skips) == 7
    assert sum(ln.startswith("CACHED ") for ln in lines) == 2 * (40 - 7)


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_batch_specs_equal_the_references_for_every_cell(arch):
    for shape in SHAPES:
        want = ref_batch_specs(jax_configs.get(arch), jax_configs.SHAPES[shape])
        got = make_batch_specs(configs.get(arch), SHAPES[shape])
        assert list(got) == list(want)
        for k, (s, dt) in got.items():
            assert s == tuple(want[k].shape), (arch, shape, k)
            assert str(dt).removeprefix("torch.") == np.dtype(want[k].dtype).name


# --- bytes a rank --------------------------------------------------------------------------


def _shard_bytes(mesh, shape, spec, itemsize) -> int:
    n = 1
    for i, d in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
        n *= d // math.prod(mesh.shape[a] for a in axes)
    return n * itemsize


def _ref_param_bytes(arch, variant):
    cfg = jax_configs.get(arch)
    shapes = jax.eval_shape(lambda: jax_init_params(cfg, jax.random.PRNGKey(0)))
    specs = ref_shardings.param_shardings(
        POD, shapes, moe_expert_axis="data" if variant == "moe-ep-data" else "model",
        fsdp=variant != "serve-tp-params")
    return sum(_shard_bytes(POD, leaf.shape, sh.spec, leaf.dtype.itemsize)
               for leaf, sh in zip(jax.tree.leaves(shapes), jax.tree.leaves(specs),
                                   strict=True))


def _ref_cache_bytes(arch, shape_name, kv_seq_shard):
    cfg, shape = jax_configs.get(arch), jax_configs.SHAPES[shape_name]
    caches = jax.eval_shape(lambda: jax_init_caches(cfg, shape.global_batch, shape.seq_len))
    specs = ref_shardings.cache_shardings(POD, caches, kv_seq_shard=kv_seq_shard)
    total = 0
    for (path, leaf), sh in zip(jax.tree_util.tree_flatten_with_path(caches)[0],
                                jax.tree.leaves(specs), strict=True):
        if getattr(path[-1], "key", None) == "pos":  # the port's is a Python int
            continue
        total += _shard_bytes(POD, leaf.shape, sh.spec, leaf.dtype.itemsize)
    return total


@pytest.fixture
def pod():
    with dryrun.fake_world("pod") as mesh:
        yield mesh


PARAM_CASES = ([(a, "baseline") for a in configs.ARCHS]
               + [(a, v) for a in ("qwen3-moe-235b-a22b", "arctic-480b", "stablelm-3b")
                  for v in ("moe-ep-data", "serve-tp-params")])


@pytest.mark.parametrize("arch,variant", PARAM_CASES)
def test_parameter_bytes_a_rank_are_the_references_shards(pod, arch, variant):
    got = dryrun.held_state(configs.get(arch), SHAPES["train_4k"], pod, variant)
    assert got["params_bytes"] == _ref_param_bytes(arch, variant)
    # AdamW's moments follow the parameters' shards, two f32 each, and the step
    n = sum(math.prod(p.shape) for p in _local_params(arch, pod, variant))
    assert got["opt_bytes"] == 8 * n + 4


def _local_params(arch, mesh, variant):
    cfg, tweaks = dryrun._apply_variant(configs.get(arch), variant)
    lay, split = dryrun._split(SHAPES["train_4k"], mesh, tweaks)
    with FakeTensorMode():
        rank = dryrun.build_rank(cfg, SHAPES["train_4k"], mesh, tweaks, lay, split)
        return [p.to_local() for p in rank.model.parameters()]


CACHE_CASES = [("gemma3-4b", "decode_32k", "baseline"), ("minicpm3-4b", "decode_32k", "baseline"),
               ("stablelm-3b", "decode_32k", "baseline"), ("whisper-base", "decode_32k", "baseline"),
               ("rwkv6-3b", "long_500k", "baseline"), ("recurrentgemma-9b", "decode_32k", "baseline"),
               ("arctic-480b", "decode_32k", "kv-seq-sharded"),
               ("qwen3-moe-235b-a22b", "prefill_32k", "kv-seq-sharded")]


@pytest.mark.parametrize("arch,shape,variant", CACHE_CASES)
def test_cache_bytes_a_rank_are_the_references_shards(pod, arch, shape, variant):
    got = dryrun.held_state(configs.get(arch), SHAPES[shape], pod, variant)
    assert got["cache_bytes"] == _ref_cache_bytes(arch, shape, variant == "kv-seq-sharded")


def test_a_sharded_cache_is_gathered_where_attention_reads_it(pod):
    """kv-seq-sharded: each rank keeps 1/16 of the sequence; the decode step
    gathers it over 'model' (one all-gather of K and V a layer) and writes
    back only this rank's shard."""
    cfg, tweaks = dryrun._apply_variant(configs.get("arctic-480b"), "kv-seq-sharded")
    cfg = dryrun.periods(cfg, 1)
    shape = SHAPES["decode_32k"]
    lay, split = dryrun._split(shape, pod, tweaks)
    with FakeTensorMode():
        rank = dryrun.build_rank(cfg, shape, pod, tweaks, lay, split)
        k = rank.caches[0]["mix"]["k"]
        assert isinstance(k, DTensor) and k.placements == (Replicate(), Shard(2))
        assert tuple(k.to_local().shape) == (8, 8, 32768 // 16, 128)
        counter = dryrun.CollectiveCounter()
        with counter:
            dryrun.run_step(rank, cfg, shape, tweaks)
        assert rank.caches[0]["mix"]["k"] is k and rank.caches[0]["mix"]["pos"] == 32768
    gathered = 2 * 8 * 8 * 32768 * 128 * 2 + 32768 * 4   # K and V whole, slot_pos
    params = counter.result()["all-gather"]["bytes"] - gathered
    assert params > 0 and counter.result()["all-gather"]["count"] >= 3


# --- FLOPs ----------------------------------------------------------------------------------


def _split(n, tp):
    """A rank's share of a dimension of n on tp 'model' ranks: n / tp where
    it divides (tensor parallelism), else all of it."""
    return n // tp if n % tp == 0 else n


def _dense_train_flops(cfg, rows, s, tp=1) -> int:
    """Σ 2 m n k over every product of a dense step: forward, full remat's
    recompute of each block, backward (each projection's dx and dw; the
    plain attention backward's scores and dP twice, dV, dK and dQ).  The
    recompute stops once the backward has every tensor it saved (torch's
    checkpoint early stop), so it skips the block's last product, the
    down projection, whose output the backward never reads.  On tp 'model'
    ranks each rank computes its share of the heads, of d_ff and of the
    vocab, where they divide."""
    d, hd = cfg.d_model, cfg.head_dim
    hq = _split(cfg.num_heads, tp)
    hkv = hq * cfg.num_kv_heads // cfg.num_heads
    f, v = _split(cfg.d_ff, tp), _split(cfg.vocab_size, tp)
    n = rows * s
    proj = 2 * n * d * (hq * hd + 2 * hkv * hd) + 2 * n * hq * hd * d
    mlp = 3 * 2 * n * d * f
    attn = 2 * rows * hq * s * s * hd           # one (S x S x D) product
    block_fwd = proj + mlp + 2 * attn
    block_bwd = 2 * (proj + mlp) + 7 * attn
    head = 2 * n * d * v
    down = 2 * n * f * d
    return cfg.num_layers * (2 * block_fwd - down + block_bwd) + 3 * head


def test_traced_flops_of_a_dense_train_step_are_the_analytic_count(pod):
    """The rows lie over 'data' (512 over 16: 32 a rank) and the 16 'model'
    peers split d_ff and the vocab (the smoke config's 4 heads do not
    divide: attention is computed whole)."""
    cfg = configs.get("stablelm-3b").scaled_down()
    shape = ShapeConfig("t", 64, 512, "train")
    got = dryrun.trace_step(cfg, shape, pod)
    assert got["flops"] == _dense_train_flops(cfg, 32, 64, tp=16)


def test_a_dense_block_splits_its_products_over_model(pod):
    """stablelm-3b at full width (32 heads, d_ff 6912, vocab 50304: each
    divides by 16), 1 layer, prefilled at 2 rows a rank: each rank's traced
    products are 1/16 of the whole forward's (its heads' projections and
    attention, its d_ff's MLP, its vocab's logits), and the 'model' peers
    sum the row-parallel products (the attention output and the MLP down
    projection, float32) and the vocab-parallel lookup (bf16) with
    all-reduces, and gather the logits along the vocab."""
    cfg = dataclasses.replace(configs.get("stablelm-3b"), num_layers=1)
    rows, s = 2, 128
    shape = ShapeConfig("p", s, 16 * rows, "prefill")
    lay, split = dryrun._split(shape, pod, set())
    with FakeTensorMode():
        rank = dryrun.build_rank(cfg, shape, pod, set(), lay, split)
        counter, flops = dryrun.CollectiveCounter(), dryrun.flop_counter()
        with flops, counter:
            dryrun.run_step(rank, cfg, shape, set())
    d, h, hd, f, v = cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.d_ff, cfg.vocab_size
    n = rows * s
    whole = (2 * n * d * 3 * h * hd + 2 * n * h * hd * d + 2 * 2 * rows * h * s * s * hd
             + 3 * 2 * n * d * f + 2 * n * d * v)
    assert flops.get_total_flops() * 16 == whole
    ops = counter.result()
    assert ops["all-reduce"] == {"count": 3, "bytes": 2 * n * d * 4 + n * d * 2}
    assert ops["all-gather"]["count"] >= 1


def test_products_with_an_f32_result_are_counted():
    """The card's products are `mm` / `bmm` with `out_dtype=float32`."""
    with FakeTensorMode():
        a = torch.empty(4, 8, dtype=torch.bfloat16)
        b = torch.empty(8, 16, dtype=torch.bfloat16)
        with dryrun.flop_counter() as fc:
            torch.mm(a, b, out_dtype=torch.float32)
            torch.bmm(a[None].expand(3, 4, 8), b[None].expand(3, 8, 16),
                      out_dtype=torch.float32)
    assert fc.get_total_flops() == 2 * 4 * 8 * 16 * (1 + 3)


def test_one_and_two_period_extrapolation_equals_a_full_depth_trace(pod):
    cfg = configs.get("stablelm-3b").scaled_down()
    shape = ShapeConfig("t", 64, 512, "train")
    whole = dryrun.trace_step(cfg, shape, pod)
    _, calibrated = dryrun.calibrate_depth(cfg, shape, pod)
    assert calibrated["flops"] == whole["flops"]
    assert calibrated["collective_bytes"] == whole["collectives"]["total_bytes"]


# --- collectives ----------------------------------------------------------------------------


def test_collective_counter_is_exact_on_a_hand_issued_sequence():
    """The counterpart of tests/test_launch.py::test_collective_byte_parser:
    a fake world of 4, one op of each kind, result bytes."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        with FakeTensorMode():
            x = torch.empty(2, 3)
            counter = dryrun.CollectiveCounter()
            with counter:
                dist.all_gather_into_tensor(torch.empty(8, 3), x)
                dist.all_reduce(x)
                dist.reduce_scatter_tensor(torch.empty(2, 3), torch.empty(8, 3))
                dist.all_to_all_single(torch.empty(4, 3), torch.empty(4, 3))
                shift(x, 1)
                bruck_all_to_all(torch.empty(4, 3))          # two shifts of 2 rows
                DTensor.from_local(x, mesh, (Shard(0), Replicate()), run_check=False
                                   ).redistribute(mesh, (Replicate(), Replicate()))
    finally:
        dist.destroy_process_group()
    assert counter.result() == {
        "all-gather": {"bytes": 96 + 48, "count": 2},
        "all-reduce": {"bytes": 24, "count": 1},
        "reduce-scatter": {"bytes": 24, "count": 1},
        "all-to-all": {"bytes": 48, "count": 1},
        "collective-permute": {"bytes": 24 + 2 * 24, "count": 3},
        "total_bytes": 96 + 48 + 24 + 24 + 48 + 72}


# --- representative cells, no card -----------------------------------------------------------


CELLS = [("stablelm-3b", "train_4k", "pod", "baseline"),
         ("internvl2-26b", "train_4k", "multipod", "baseline"),
         ("qwen3-moe-235b-a22b", "decode_32k", "pod", "moe-ep-data"),
         ("whisper-base", "prefill_32k", "multipod", "baseline"),
         ("minicpm3-4b", "decode_32k", "both", "baseline"),
         ("gemma3-4b", "decode_32k", "multipod", "baseline"),
         ("recurrentgemma-9b", "decode_32k", "pod", "baseline"),
         ("rwkv6-3b", "long_500k", "multipod", "baseline"),
         ("stablelm-3b", "decode_32k", "pod", "logits-sharded")]


@pytest.mark.parametrize("arch,shape,mesh,variant", CELLS)
def test_representative_cells_trace_on_a_fake_world(tmp_path, capsys, arch, shape, mesh,
                                                    variant):
    argv = ["--arch", arch, "--shape", shape, "--mesh", mesh, "--variant", variant,
            "--out", str(tmp_path)]
    dryrun.main(argv)
    meshes = ["pod", "multipod"] if mesh == "both" else [mesh]
    suffix = "" if variant == "baseline" else f"__{variant}"
    lines = capsys.readouterr().out.splitlines()
    for mk in meshes:
        tag = f"{arch}__{shape}__{mk}{suffix}"
        assert f"RUN {tag} ..." in lines
        assert any(ln.startswith(f"OK {tag} flops=") for ln in lines), lines
        res = json.loads((tmp_path / f"{tag}.json").read_text())
        assert res["devices"] == (512 if mk == "multipod" else 256)
        assert res["mode"] == SHAPES[shape].mode and res["variant"] == variant
        assert res["flops"] > 0 and res["collectives"]["total_bytes"] > 0
        assert res["calibrated"]["flops"] >= res["flops"]
        mem = res["memory"]
        assert mem["held_bytes"] == sum(mem[k] for k in ("params_bytes", "opt_bytes",
                                                         "cache_bytes", "batch_bytes"))
        assert (mem["opt_bytes"] > 0) == (res["mode"] == "train")
        assert (mem["cache_bytes"] > 0) == (res["mode"] != "train")
    if variant == "logits-sharded":
        assert res["logits_shape"] == [8, configs.get(arch).vocab_size // 16]
    dryrun.main(argv)
    assert capsys.readouterr().out.splitlines() == [
        f"CACHED {arch}__{shape}__{mk}{suffix}" for mk in meshes]
    assert not dist.is_initialized()


def test_seq_parallel_is_traced_as_the_baseline_with_a_note(tmp_path, capsys):
    """The port keeps the sequence whole: a seq-parallel cell records the
    baseline's numbers and says so in its JSON."""
    res = {}
    for variant in ("baseline", "seq-parallel"):
        dryrun.main(["--arch", "stablelm-3b", "--shape", "decode_32k", "--mesh", "pod",
                     "--variant", variant, "--out", str(tmp_path)])
        suffix = "" if variant == "baseline" else f"__{variant}"
        res[variant] = json.loads((tmp_path / f"stablelm-3b__decode_32k__pod{suffix}.json")
                                  .read_text())
    base, seq = res["baseline"], res["seq-parallel"]
    for key in ("flops", "collectives", "calibrated"):
        assert seq[key] == base[key], key
    assert seq["memory"] == base["memory"]
    assert "seq_parallel_note" in seq and "seq_parallel_note" not in base
    assert not dist.is_initialized()
