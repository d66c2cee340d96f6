"""Port parity of the launch layer: the sharding rules, every
``*_axes`` table (``param_axes``), ``input_specs``/``input_axes``, the
cells (``configs.shapes``), ``launch.steps``' rule selection and
microbatch count, the cell plans' steps, ``launch.mesh`` and the serving
CLI, against the JAX package.

The rules read only ``mesh.shape``, so both packages resolve the same
abstract meshes (``{data: 1, model: 1}``, ``{data: 16, model: 16}``,
``{pod: 2, data: 16, model: 16}``; a ``SimpleNamespace``) at the FULL
configs' leaf shapes (the port's meta params, ``param_specs``). The
plans run on the CPU (``make_test_mesh(1, 1, device="cpu")``) on the
JAX package's SMOKE weights carried across, against the JAX scale
model's ``prefill``/``decode_step``; the train plans are
tests/test_torch_launch_train.py. Tolerances: the prefill and decode
plans' logits 1e-5 of max |ref|; the rules, axes, specs and counts
exactly.
"""
import dataclasses
from collections import OrderedDict
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as j_arch
from repro.config import get_smoke_arch as j_smoke
from repro.config.base import InputShape as JShape
from repro.configs import shapes as j_shapes
from repro.launch import steps as j_steps
from repro.models import build_model as j_build_model
from repro.models import input_axes as j_input_axes
from repro.models import input_specs as j_input_specs
from repro.sharding import rules as j_rules
from repro_torch.checkpoint import flatten_with_paths
from repro_torch.config import ALL_SHAPES, SINGLE_POD, TEST_MESH, InputShape
from repro_torch.config import get_arch, get_smoke_arch, list_archs
from repro_torch.configs import shapes
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import steps
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import build_model, input_axes, input_specs
from repro_torch.models import common, params_from_jax
from repro_torch.optimizer import adamw
from repro_torch.sharding import rules
from torch_jax_state import no_jax_constrainer  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

MESHES = {"1x1": {"data": 1, "model": 1},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
ARCHS = list_archs()
REL = 1e-5


def _mesh(name):
    return SimpleNamespace(shape=dict(MESHES[name]))


def _j_shape(shape):
    return JShape(shape.name, shape.seq_len, shape.global_batch, shape.kind)


def _leaves(tree, prefix=()):
    """[(path, leaf)] of a dictionary tree whose leaves are anything but
    dictionaries (axes tuples, tensors, ShapeDtypeStructs)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _leaves(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def _dtype(d) -> str:
    return str(d).split(".")[-1] if isinstance(d, torch.dtype) \
        else np.dtype(d).name


def _carry(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def _rel_err(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.detach().float().numpy() - want).max()
                 / np.abs(want).max())


def test_arch_cells_match_jax():
    mine = [(a, dataclasses.asdict(s), r) for a, s, r in shapes.arch_cells()]
    theirs = [(a, dataclasses.asdict(s), r)
              for a, s, r in j_shapes.arch_cells()]
    assert len(mine) == 40 and mine == theirs
    assert shapes.arch_cells("rwkv6-7b") == \
        [c for c in shapes.arch_cells() if c[0] == "rwkv6-7b"]
    for a, s, r in shapes.arch_cells():
        assert shapes.cell_is_runnable(a, s) == (r is None) == \
            j_shapes.cell_is_runnable(a, _j_shape(s))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_match_jax_and_the_params(arch):
    """The axes tree equals JAX's, leaf for leaf, and has the keys of
    the port's params (SMOKE drawn, FULL as meta tensors), each leaf one
    name a dimension."""
    for cfg_t, cfg_j in ((get_arch(arch), j_arch(arch)),
                         (get_smoke_arch(arch), j_smoke(arch))):
        axes = build_model(cfg_t).param_axes()
        assert axes == j_build_model(cfg_j).param_axes()
        full = cfg_t.name == arch
        model = build_model(cfg_t)
        params = (common.param_specs(model) if full
                  else model.init(torch.Generator().manual_seed(0)))
        ax, pa = _leaves(axes), _leaves(params)
        assert [p for p, _ in ax] == [p for p, _ in pa]
        assert sorted("/".join(p) for p, _ in pa) == sorted(
            k for k, _ in flatten_with_paths(params))
        for (path, a), (_, t) in zip(ax, pa):
            assert rules.is_axes(a) and len(a) == t.dim(), path


@pytest.mark.parametrize("arch", ARCHS)
def test_rules_resolve_every_param_as_jax(arch):
    """RuleSet.spec of every FULL leaf and the fallback report, on the
    three abstract meshes, under rules_for's table of each shape."""
    cfg = get_arch(arch)
    model = build_model(cfg)
    leaves = list(zip([a for _, a in _leaves(model.param_axes())],
                      [tuple(t.shape) for _, t in
                       _leaves(common.param_specs(model))]))
    for name in MESHES:
        for shape in ALL_SHAPES:
            mine = steps.rules_for(cfg, shape, _mesh(name))
            theirs = j_steps.rules_for(j_arch(arch), _j_shape(shape),
                                       _mesh(name))
            assert mine.rules == theirs.rules
            for axes, dims in leaves:
                got = mine.spec(axes, dims)
                assert isinstance(got, rules.P)
                assert tuple(got) == tuple(theirs.spec(axes, dims)), \
                    (name, axes, dims)
            assert mine.fallback_report() == theirs.fallback_report()
            assert steps.needs_fsdp(cfg) == j_steps.needs_fsdp(j_arch(arch))
            assert steps.default_microbatches(shape, _mesh(name), cfg) == \
                j_steps.default_microbatches(_j_shape(shape), _mesh(name),
                                             j_arch(arch))


def test_rule_scenarios_match_jax():
    """The JAX rule tests' scenarios, on both packages: basic resolution,
    the divisibility fallback, no axis reused, overrides; the sharding
    record; the tree helper."""
    one = t_mesh.make_test_mesh(1, 1, device="cpu")
    two = SimpleNamespace(shape={"data": 2, "model": 1})
    cases = [(one, None, ("batch", "seq", "embed"), (8, 16, 32)),
             (two, None, ("batch",), (3,)),
             (two, None, ("batch",), (4,)),
             (_mesh("2x16x16"), None, ("batch", "embed"), (64, 8)),
             (_mesh("2x16x16"), None, ("batch", "kv_seq"), (16, 64)),
             (one, {"seq": "data"}, (None, "seq"), (2, 4)),
             (_mesh("16x16"), {"seq": "data"}, ("batch", "seq"), (32, 64)),
             (_mesh("16x16"), {"embed": ("data", "model")},
              ("embed", "mlp"), (4096, 14336)),
             (_mesh("16x16"), None, ("heads", "act_heads"), None)]
    for mesh, over, axes, dims in cases:
        jm = SimpleNamespace(shape=dict(mesh.shape))
        mine = rules.RuleSet(mesh, overrides=over)
        theirs = j_rules.RuleSet(jm, overrides=over)
        got = mine.spec(axes, dims)
        assert tuple(got) == tuple(theirs.spec(axes, dims)), (axes, dims)
        assert mine.fallback_report() == theirs.fallback_report()
        used = [a for part in got for a in
                ((part,) if isinstance(part, str) else (part or ()))]
        assert len(used) == len(set(used))
    rs = rules.RuleSet(two)
    assert rs.spec(("batch",), (3,)) == rules.P()
    assert any("batch" in r for r in rs.fallback_report())
    assert rules.RuleSet(one, overrides={"seq": "data"}).spec(
        (None, "seq"), (2, 4)) == rules.P(None, "data")
    sh = rs.sharding(("batch", None), (4, 2))
    assert sh == rules.NamedSharding(two, rules.P("data"))
    tree = {"a": ("batch", None), "b": {"c": ()}}
    meta = {"a": torch.empty((4, 2), device="meta"),
            "b": {"c": torch.empty((), device="meta")}}
    assert rules.tree_shardings(rs, tree, meta) == \
        {"a": rules.NamedSharding(two, rules.P("data")),
         "b": {"c": rules.NamedSharding(two, rules.P())}}


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_axes_match_jax(arch):
    for shape in ALL_SHAPES:
        js = _j_shape(shape)
        assert input_axes(get_arch(arch), shape) == \
            j_input_axes(j_arch(arch), js)
        mine = _leaves(input_specs(get_arch(arch), shape))
        theirs = _leaves(j_input_specs(j_arch(arch), js))
        assert [p for p, _ in mine] == [p for p, _ in theirs]
        for (path, t), (_, j) in zip(mine, theirs):
            assert t.device.type == "meta", path
            assert tuple(t.shape) == tuple(j.shape), path
            assert _dtype(t.dtype) == _dtype(j.dtype), path


def test_meshes():
    """Production meshes are abstract; a mesh of more than one device from
    one controller has no one device to run a step on; a model axis over
    1 needs SPMD processes (none is started here:
    ``tests/test_torch_model_axis.py`` runs them); a data mesh takes
    distinct devices and the process has one CPU device; a mesh built
    directly may repeat one; a one-device mesh has its device."""
    pm = t_mesh.make_production_mesh()
    assert dict(pm.shape) == {"data": 16, "model": 16} and pm.size == 256
    assert pm.devices is None
    mp = t_mesh.make_production_mesh(multi_pod=True)
    assert mp.axes == ("pod", "data", "model") and mp.size == 512
    cpu = torch.device("cpu")
    repeated = t_mesh.Mesh(OrderedDict(data=4), (cpu,) * 4)
    assert repeated.size == 4 and repeated.devices == (cpu,) * 4
    for call in (lambda: pm.device, lambda: repeated.device):
        with pytest.raises(NotImplementedError, match="more than one"):
            call()
    for call in (lambda: t_mesh.make_test_mesh(1, 2, device="cpu"),
                 lambda: t_mesh.make_mesh(SINGLE_POD, device="cpu")):
        with pytest.raises(NotImplementedError, match="SPMD processes"):
            call()
    for call in (lambda: t_mesh.make_test_mesh(2, 1, device="cpu"),
                 lambda: t_mesh.make_scoring_mesh(4, device="cpu")):
        with pytest.raises(ValueError, match="the process has 1"):
            call()
    one = t_mesh.make_test_mesh(1, 1, device="cpu")
    assert one.device == torch.device("cpu") and one.axes == ("data", "model")
    assert t_mesh.make_scoring_mesh(device="cpu").axes == ("data",)
    assert t_mesh.make_mesh(TEST_MESH, device="cpu").size == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_mesh.make_test_mesh(1, 1)


def test_plans_on_a_production_mesh_resolve_and_refuse_to_run():
    """A plan over the production mesh gives its specs (JAX's rules at
    FULL shapes) and meta arguments; its step traces those meta
    arguments (the dry run's use) and raises on real tensors."""
    cfg = get_arch("llama3-8b")
    pm = t_mesh.make_production_mesh()
    for shape in ALL_SHAPES:
        plan = steps.make_plan(cfg, shape, pm)
        assert plan.description == {
            "train": "train llama3-8b train_4k (microbatches=4)",
            "prefill": "prefill llama3-8b prefill_32k",
            "decode": f"decode llama3-8b {shape.name}"}[shape.kind]
        for _, t in _leaves(plan.arg_sds[1]):
            assert t.device.type == "meta"
    train = steps.make_train_plan(cfg, ALL_SHAPES[0], pm)
    (p_sh, opt_sh), batch_sh = train.arg_shardings
    assert p_sh["blocks"]["p0"]["attn"]["wq"].spec == \
        rules.P(None, "data", "model")
    assert isinstance(opt_sh, adamw.AdamWState)
    assert opt_sh.step == rules.NamedSharding(pm, rules.P())
    assert batch_sh["tokens"].spec == rules.P("data")
    params_sds, opt_sds = train.arg_sds[0]
    assert opt_sds.mu["embed"]["table"].dtype == torch.float32
    assert sum(t.numel() for _, t in _leaves(params_sds)) == 8030261248
    with pytest.raises(NotImplementedError, match="more than one"):
        train.step_fn(({"embed": {"table": torch.zeros(1)}}, opt_sds), {})
    prefill = steps.make_plan(cfg, ALL_SHAPES[1], pm, last_logit=True)
    last, _ = prefill.step_fn(*prefill.arg_sds)
    assert last.device.type == "meta"
    assert tuple(last.shape) == (ALL_SHAPES[1].global_batch,
                                 cfg.padded_vocab_size)


@pytest.mark.parametrize("arch", ["llama3-8b", "rwkv6-7b", "whisper-base",
                                  "internvl2-1b"])
def test_prefill_and_decode_plans_match_jax(arch):
    """The prefill plan's last logits (``last_logit`` on and off) and the
    decode plan's logits after a prefill, against the JAX scale model's
    ``prefill``/``decode_step``."""
    cfg_j = dataclasses.replace(j_smoke(arch), dtype="float32")
    cfg_t = dataclasses.replace(get_smoke_arch(arch), dtype="float32")
    B, S = 2, 24
    jm = j_build_model(cfg_j, attn_impl="flash", rwkv_mode="factored")
    jp = jm.init(jax.random.PRNGKey(2))
    tp = _carry(jp)
    rng = np.random.default_rng(3)
    tokens = rng.integers(1, cfg_j.vocab_size, (B, S)).astype(np.int32)
    mesh = t_mesh.make_test_mesh(1, 1, device="cpu")
    if cfg_j.is_encdec:
        frames = rng.normal(size=(B, S, cfg_j.d_model)).astype(np.float32)
        batch = {"frames": frames, "tokens": tokens}
        want, j_cache = jm.prefill(jp, jnp.asarray(frames),
                                   jnp.asarray(tokens))
    elif cfg_j.frontend != "none":
        embeds = rng.normal(size=(B, S, cfg_j.d_model)).astype(np.float32)
        batch = {"embeds": embeds}
        want, j_cache = jm.prefill(jp, jnp.asarray(embeds))
    else:
        batch = {"tokens": tokens}
        want, j_cache = jm.prefill(jp, jnp.asarray(tokens))
    shape = InputShape("p", S, B, "prefill")
    for last in (False, True):
        plan = steps.make_prefill_plan(cfg_t, shape, mesh, last_logit=last)
        got, cache = plan.step_fn(tp, batch)
        assert got.shape == (B, cfg_t.padded_vocab_size)
        assert _rel_err(got, np.asarray(want)[:, -1]) < REL
    # decode: the token after the prompt, at its position
    pos = S if cfg_j.is_encdec else S - 1
    if not cfg_j.is_encdec:
        inputs = embeds if cfg_j.frontend != "none" else tokens
        _, j_cache = jm.prefill(jp, jnp.asarray(inputs[:, :-1]),
                                cache_len=S)
        _, cache = build_model(cfg_t, rwkv_mode="factored").prefill(
            tp, torch.tensor(inputs[:, :-1]), cache_len=S)
    step_tok = tokens[:, -1:]
    want_d, _ = jm.decode_step(jp, jnp.asarray(step_tok), jnp.int32(pos),
                               j_cache)
    dplan = steps.make_decode_plan(cfg_t, InputShape("d", S, B, "decode"),
                                   mesh)
    got_d, new_cache = dplan.step_fn(tp, {"tokens": step_tok, "pos": pos,
                                          "cache": cache})
    assert got_d.shape == (B, cfg_t.padded_vocab_size)
    assert _rel_err(got_d, np.asarray(want_d)[:, -1]) < REL
    specs = _leaves(dplan.arg_sds[1]["cache"])
    assert [tuple(t.shape) for _, t in _leaves(new_cache)] == \
        [tuple(t.shape) for _, t in specs]


def test_build_model_for_scale():
    """flash attention and the factored WKV6; causal_skip accepted; the
    activation constraint only with a ruleset."""
    cfg = get_smoke_arch("rwkv6-7b")
    model = steps.build_model_for_scale(cfg, causal_skip=True)
    assert (model.attn_impl, model.rwkv_mode) == ("flash", "factored")
    assert model.act_constraint is None
    rs = steps.rules_for(cfg, ALL_SHAPES[1], _mesh("16x16"))
    model = steps.build_model_for_scale(cfg, ruleset=rs, moe_dispatch="sort")
    with pytest.raises(NotImplementedError, match="more than one"):
        model.act_constraint(torch.zeros(2, 4, 64))
    rs1 = steps.rules_for(cfg, ALL_SHAPES[1], _mesh("1x1"))
    x = torch.zeros(3, 4, 64)
    assert steps.build_model_for_scale(cfg, ruleset=rs1).act_constraint(x) \
        is x
    enc = steps.build_model_for_scale(get_smoke_arch("whisper-base"))
    assert enc.attn_impl == "flash"
    assert steps.replicated(_mesh("1x1")).spec == rules.P()


def test_serve_cli_writes_the_services_embeddings(tmp_path):
    """``--device cpu --smoke --out``: the EmbeddingService's embeddings
    of the same corpus under the same params (seed 0), bitwise."""
    from repro_torch.data import make_corpus
    from repro_torch.runtime.serve_loop import EmbeddingService
    out = tmp_path / "embeds.npy"
    serve_main(["--arch", "smollm-360m", "--smoke", "--docs", "20",
                "--device", "cpu", "--out", str(out)])
    got = np.load(out)
    cfg = get_smoke_arch("smollm-360m")
    corpus = make_corpus(0, n_docs=20, dim=128, with_tokens=True,
                         vocab=min(cfg.vocab_size, 256), doc_len=48)
    params = build_model(cfg).init(torch.Generator("cpu").manual_seed(0))
    want = EmbeddingService(cfg, params, batch_size=8, device="cpu"
                            ).embed_documents(list(corpus.tokens[:20]))
    assert got.shape == (20, cfg.d_model)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("layers", [3, 2])
def test_encoder_axes_match_jax_and_the_proxy(layers):
    """The proxy encoder's axes table: JAX's, with encoder_init's keys."""
    from repro.config import ProxyConfig as JProxy
    from repro.core.encoder import encoder_axes as j_encoder_axes
    from repro_torch.config import ProxyConfig
    from repro_torch.core.encoder import encoder_axes, encoder_init
    cfg = ProxyConfig(embed_dim=16, hidden_dim=8, latent_dim=4,
                      num_layers=layers)
    axes = encoder_axes(cfg)
    assert axes == j_encoder_axes(JProxy(num_layers=layers))
    params = encoder_init(torch.Generator().manual_seed(0), cfg)
    ax, pa = _leaves(axes), _leaves(params)
    assert [p for p, _ in ax] == [p for p, _ in pa]
    assert all(len(a) == t.dim() for (_, a), (_, t) in zip(ax, pa))
