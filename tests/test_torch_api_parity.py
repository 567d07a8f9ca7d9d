"""The interface of rt_tpu_torch against rt_tpu's, read from their source.

Both packages are parsed with `ast` and neither is imported (no JAX
start). Every public function of a module of rt_tpu/, and every public
method of its public classes, must have a counterpart of the same name in
the matching module of rt_tpu_torch/ that takes every one of its
parameters. The matching module has the same path, except that
ops/pallas_*.py match ops/cuda_*.py, where the CUDA kernels' wrappers
live, and the table builders of pallas_mega.py may live in
ops/mega_tables.py or ops/camera.py instead. A gap is allowed only where
ALLOWED or ALLOWED_PARAMS names it with its reason.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF, PORT = "rt_tpu", "rt_tpu_torch"

# extra modules of the port where a reference module's names may live
ALSO_IN = {"ops/pallas_mega.py": ("ops/mega_tables.py", "ops/camera.py")}

# parameters the port takes nowhere: the NumPy / jax.numpy module switch
# of the reference's shared helpers (the port's are torch only)
NEVER = {"xp"}

# (reference module, name): why the port has no counterpart
ALLOWED = {
    ("ops/geometry.py", "einsum"):
        "a jnp / np einsum shim; the port writes its products out in torch",
    ("ops/geometry.py", "onehot_gather"):
        "the TPU's one-hot MXU gather; the port gathers by index",
    ("ops/camera.py", "make_camera_jnp"):
        "make_camera traced by JAX; the port's make_camera is torch already",
    ("diff/inverse.py", "pixel_sharding"):
        "a jax.sharding layout; the port's mesh splits rows by rank",
    ("ops/pallas_mega.py", "sphere_uv_table"):
        "a Pallas table builder; the CUDA kernels compute a sphere's UV",
    ("ops/pallas_mega.py", "sphere_coeff_tables"):
        "the MXU coefficient rows of mxu_intersect, a TPU mechanism",
    ("ops/pallas_mega.py", "nee_light_table"):
        "a Pallas table builder; the kernels read mega_tables.light_table",
    ("ops/pallas_mega.py", "image_atlas_rows"):
        "the Pallas double-one-hot atlas planes; the kernels read texels",
    ("ops/pallas_mega.py", "capture_segment"):
        "an inner Pallas launcher; B4 is launched by cuda_mega.mega_capture",
    ("ops/pallas_mega.py", "adjoint_segment"):
        "an inner Pallas launcher; B5's is cuda_mega.mega_adjoint_segment",
    ("ops/pallas_mega.py", "adjoint_atlas_ok"):
        "a TPU VMEM limit; B5 / B6 add the atlas gradient at any size",
}

# (reference module, function): its parameters the port's lacks, and why
_PACKED = ("a Pallas launcher's table and flag arguments; its CUDA "
           "counterpart takes the packed table and options")
ALLOWED_PARAMS = {
    ("ops/pallas_intersect.py", "sphere_closest_hit"): (
        {"interpret"}, "Pallas interpret mode, a JAX mechanism"),
    ("ops/pallas_mega.py", "mega_segment"): (None, _PACKED),
    ("ops/pallas_mega.py", "mega_regen"): (None, _PACKED),
    ("ops/pallas_queue.py", "queue_launch"): (None, _PACKED),
    ("ops/pallas_queue.py", "queue_adjoint_launch"): (None, _PACKED),
    ("parallel/distributed.py", "init_distributed"): (
        {"coordinator_address", "num_processes", "process_id"},
        "jax.distributed.initialize's coordinator; the port takes "
        "torch.distributed's init_method, world_size and rank"),
    ("parallel/mesh.py", "make_mesh"): (
        {"devices"}, "a list of JAX devices; a port rank holds one device"),
    ("render/renderer.py", "render"): (
        {"device_out"}, "the port always returns the device tensor"),
}


def _params(fn):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return names


def _public(path):
    """{name: parameter list} of a module's public functions, and of its
    public classes' public methods and __init__ as "Class.method"."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith(
                "_"):
            out[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith(
                "_"):
            for m in node.body:
                if isinstance(m, ast.FunctionDef) and (
                        not m.name.startswith("_") or m.name == "__init__"):
                    out[f"{node.name}.{m.name}"] = _params(m)
    return out


def _port_module(rel):
    d, base = os.path.split(rel)
    if d == "ops" and base.startswith("pallas_"):
        base = "cuda_" + base[len("pallas_"):]
    return os.path.join(d, base)


def _reference_modules():
    mods = []
    for root, _, files in os.walk(os.path.join(ROOT, REF)):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f),
                                      os.path.join(ROOT, REF))
                mods.append(rel.replace(os.sep, "/"))
    return sorted(m for m in mods if _public(os.path.join(ROOT, REF, m)))


MODULES = _reference_modules()


def _gaps(rel):
    """The reference module's names and parameters the port lacks."""
    ref = _public(os.path.join(ROOT, REF, rel))
    homes = (_port_module(rel),) + ALSO_IN.get(rel, ())
    port = {}
    for home in reversed(homes):
        path = os.path.join(ROOT, PORT, home)
        if os.path.exists(path):
            port.update(_public(path))
    gaps = []
    for name, params in sorted(ref.items()):
        if (rel, name) in ALLOWED:
            continue
        if name not in port:
            gaps.append(f"{rel}: {name} has no counterpart in {homes}")
            continue
        allowed, _ = ALLOWED_PARAMS.get((rel, name), (set(), ""))
        if allowed is None:
            continue
        lack = [p for p in params if p not in port[name]
                and p not in NEVER and p not in allowed]
        if lack:
            gaps.append(f"{rel}: {name} lacks {lack}")
    return gaps


def test_modules_found():
    """The walk sees the reference's modules, among them the kernels'."""
    assert len(MODULES) > 30
    for rel in ("config.py", "ops/pallas_mega.py", "diff/replay.py",
                "render/integrator.py", "parallel/sharded.py"):
        assert rel in MODULES


@pytest.mark.parametrize("rel", MODULES)
def test_every_public_name_has_a_counterpart(rel):
    assert _gaps(rel) == []


def test_allowlists_name_real_gaps():
    """Each allowlisted exception names something the reference has and
    the port lacks, and gives its reason: a stale entry fails."""
    for (rel, name), why in list(ALLOWED.items()) + [
            (k, v[1]) for k, v in ALLOWED_PARAMS.items()]:
        assert why and rel in MODULES, (rel, name)
        ref = _public(os.path.join(ROOT, REF, rel))
        assert name in ref, (rel, name)
    for (rel, name) in ALLOWED:
        homes = (_port_module(rel),) + ALSO_IN.get(rel, ())
        for home in homes:
            path = os.path.join(ROOT, PORT, home)
            assert not (os.path.exists(path) and name in _public(path)), (
                rel, name, home)
    for (rel, name), (params, _) in ALLOWED_PARAMS.items():
        ref = _public(os.path.join(ROOT, REF, rel))
        port = _public(os.path.join(ROOT, PORT, _port_module(rel)))
        missing = set(ref[name]) - set(port[name])
        assert missing, (rel, name)
        if params is not None:
            assert params <= missing, (rel, name, params - missing)


def test_replay_takes_the_reference_order():
    """make_replay_render / make_replay_loss_fn take the reference's
    parameters in the reference's positional order, the port's own
    after them as keyword-only."""
    for name in ("make_replay_render", "make_replay_loss_fn"):
        ref = _public(os.path.join(ROOT, REF, "diff/replay.py"))[name]
        with open(os.path.join(ROOT, PORT, "diff/replay.py")) as f:
            fn = next(n for n in ast.parse(f.read()).body
                      if isinstance(n, ast.FunctionDef) and n.name == name)
        positional = [a.arg for a in fn.args.args]
        assert positional == ref, name
        assert [a.arg for a in fn.args.kwonlyargs] == (
            ["row_offset"] if name == "make_replay_loss_fn" else [])
