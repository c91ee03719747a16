"""What the program needs around it: the compile cache's place, the
dispatch table, `chip_smoke.py`'s refusal without a GPU, the dependency
set of the main path, and the models' parameter trees."""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from maxk_gnn.ops.dispatch import KernelMode, choose_mode, device_constants
from maxk_gnn.runtime import REPO_ROOT, enable_compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_follows_env(monkeypatch, tmp_path, restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compile_cache_in_checkout_when_unset(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = enable_compile_cache()
    assert path == os.path.join(REPO_ROOT, ".jax_cache") == os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_dispatch_cpu_entry_is_segsum(small_graph):
    assert device_constants() is None  # the CPU has no planning rates
    for cdt in (None, jnp.bfloat16):
        assert choose_mode("auto", small_graph, 256, cdt) == KernelMode.SEGSUM
    # explicit modes pass through untouched
    assert choose_mode("tiles_scan", small_graph, 256) == KernelMode.TILES_SCAN


def test_dispatch_unknown_device_raises(small_graph):
    class Card:
        device_kind = "Imaginary Accelerator 9000"

    with pytest.raises(ValueError, match="Imaginary Accelerator 9000.*kernel_mode"):
        device_constants(Card())
    with pytest.raises(ValueError, match="kernel_mode"):
        choose_mode("auto", small_graph, 256, jnp.bfloat16, device=Card())
    # an explicit mode needs no constants
    assert choose_mode("segsum", small_graph, 256, device=Card()) == KernelMode.SEGSUM


@pytest.mark.parametrize("v,e_live,memory,want", [
    (232_965, 79_037_029, 63_763_120_128, KernelMode.SEGSUM),  # reddit
    (2_449_029, 123_700_000, 63_763_120_128, KernelMode.SEGSUM),  # products
    # a quarter of the memory leaves a narrow strip that the rule takes
    (2_449_029, 123_700_000, 16_000_000_000, KernelMode.HYBRID),
])
def test_dispatch_h100_follows_planning_rule(v, e_live, memory, want):
    """On the H100 `auto` is decided by `hybrid_profitable` over the
    measured rates and the card's `bytes_limit`, and only under bf16."""
    class Card:
        device_kind = "NVIDIA H100 80GB HBM3"

        def memory_stats(self):
            return {"bytes_limit": memory}

    class Csr:  # what the rule reads of a graph: sizes and edge values
        num_nodes = v
        indptr = np.array([0, e_live], np.int32)
        values = np.ones(4, np.float32)

    assert choose_mode("auto", Csr(), 256, jnp.bfloat16, device=Card()) == want
    assert choose_mode("auto", Csr(), 256, None, device=Card()) == KernelMode.SEGSUM


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def _ok_lines(stdout):
    out = []
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok"):
                out.append(line)
        except (ValueError, AttributeError):
            pass
    return out


def test_chip_smoke_fails_without_gpu():
    r = _run_smoke(ROOT)
    assert r.returncode != 0
    assert not _ok_lines(r.stdout)
    assert "no GPU" in r.stderr


def test_chip_smoke_fails_without_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run_smoke(tmp_path)
    assert r.returncode != 0
    assert not _ok_lines(r.stdout)
    assert "checkout" in r.stderr


BLOCKED_RUN = """
import sys
for m in ("flax", "flax.linen", "flax.struct", "orbax", "orbax.checkpoint",
          "tensorboardX"):
    sys.modules[m] = None  # import raises ImportError
import jax
jax.config.update("jax_platforms", "cpu")
import train
state = train.main(sys.argv[1:])
assert len(state.losses) == 2, state.losses
loaded = sorted(m for m in ("flax", "orbax", "tensorboardX")
                if sys.modules.get(m) is not None)
assert not loaded, loaded
print("BLOCKED_OK", state.kernel_mode)
"""


def test_train_runs_without_flax_orbax_tensorboard(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    r = subprocess.run(
        [sys.executable, "-c", BLOCKED_RUN,
         "--dataset", "flickr", "--model", "sage", "--epochs", "2",
         "--hidden_dim", "16", "--hidden_layers", "2", "--maxk", "4",
         "--data_scale", "0.002", "--checkpoint_every", "1",
         "--path", str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert "BLOCKED_OK segsum" in r.stdout


_DENSE = lambda i, o: {"kernel": (i, o), "bias": (o,)}  # noqa: E731
_CONV = {
    "sage": lambda h: {"fc_neigh": {"kernel": (h, h)}, "fc_self": _DENSE(h, h)},
    "gcn": lambda h: {"weight": _DENSE(h, h)},
    "gin": lambda h: {"apply_func_0": _DENSE(h, h), "apply_func_1": _DENSE(h, h),
                      "eps": ()},
    "gnn_res": lambda h: {"weight": _DENSE(h, h)},
}


@pytest.mark.parametrize("family", ["sage", "gcn", "gin", "gnn_res"])
def test_param_tree_names_and_shapes(family, small_graph):
    from maxk_gnn.models.models import build_model
    from maxk_gnn.sparse.graph import build_graph

    f_in, h, out, layers = 32, 16, 5, 2
    model, norm = build_model(family, out_dim=out, hidden_dim=h,
                              num_layers=layers, maxk=4, kernel_mode="segsum")
    g = build_graph(small_graph, norm=norm)
    x = jnp.ones((small_graph.num_nodes, f_in))
    variables = model.init({"params": jax.random.PRNGKey(0)}, g, x)
    params = {"lin_in": _DENSE(f_in, h), "lin_out": _DENSE(h, out)}
    want = {"params": params}
    for i in range(layers):
        params[f"conv{i}"] = _CONV[family](h)
        if family == "gnn_res":
            params[f"bn{i}"] = {"scale": (h,), "bias": (h,)}
            want.setdefault("batch_stats", {})[f"bn{i}"] = {"mean": (h,), "var": (h,)}
    got = jax.tree.map(lambda a: tuple(a.shape), variables)
    assert got == want
    assert all(a.dtype == jnp.float32 for a in jax.tree.leaves(variables))
