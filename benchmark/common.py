"""What the harness finds by name: the manifest's cells, each
configuration's file and plain reference, each traffic mix, each cell's
limits and each per-layer metric's reader; and the seeded weights that
both the program and the reference start from."""

from __future__ import annotations

import importlib.util
import json
import os

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell(name: str, man: dict = None) -> dict:
    """The manifest's entry of workload ``name``, with its configuration
    (``config_entry``), the configuration file's content (``conf``), the
    traffic mix (``traffic``), the limits (``limits``) and the per-layer
    metrics it reports (``per_layer``)."""
    man = man or manifest()
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    w = dict(cells[name])
    entry = {c["name"]: c for c in man["configs"]}[w["config"]]
    w["config_entry"] = entry
    w["conf"] = load_json(os.path.join(ROOT, entry["file"]))
    w["traffic_mix"] = load_json(traffic_path(w["traffic"]))
    w["limits"] = load_json(os.path.join(HERE, "limits", f"{name}.json"))
    w["per_layer"] = [m for m in man["per_layer"]
                      if name in m.get("workloads", [name])]
    w["end_to_end"] = [m for m in man["end_to_end"]
                       if name in m.get("workloads", [name])]
    return w


def traffic_path(name: str) -> str:
    return os.path.join(HERE, "traffic", f"{name}.json")


def load_file_module(path: str, name: str):
    """A module from a file whose name is not an identifier (a
    configuration's reference, a metric's reader)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_module(config_file: str):
    """The plain reference beside a configuration's file: ``<name>.py``
    next to ``<name>.json``."""
    path = os.path.join(ROOT, os.path.splitext(config_file)[0] + ".py")
    return load_file_module(path, "bench_ref_" + os.path.basename(
        path)[:-3].replace("-", "_").replace(".", "_"))


def metric_reader(name: str):
    return load_file_module(os.path.join(HERE, "metrics", f"{name}.py"),
                            "bench_metric_" + name.replace(".", "_"))


def init_bound(name: str, tree: dict) -> float:
    """The uniform bound of leaf ``name`` under the initializers the model
    publishes: glorot for the SAGE layers' weights, ``1/sqrt(fan_in)`` for
    every other Linear weight and bias and for the codebook's rows."""
    t = tree[name]
    if name.endswith(".w"):
        fan_in, fan_out = t.shape[0], t.shape[-1]
        if ".lin_l." in name or ".lin_r." in name:
            return (6.0 / (fan_in + fan_out)) ** 0.5
        return fan_in ** -0.5
    if name.endswith(".b"):
        return tree[name[:-1] + "w"].shape[0] ** -0.5
    if name.endswith("embed"):
        return t.shape[-1] ** -0.5
    raise KeyError(name)


@torch.no_grad()
def seeded_weights(named: dict, seed: int, device) -> dict:
    """Fresh values of the parameters ``named`` (name -> tensor), made on
    ``device`` from one uniform draw of a generator seeded with ``seed``:
    BatchNorm's scale 1 and bias 0, every other leaf uniform within its
    :func:`init_bound`, the codebook's rows of unit length."""
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(t.numel() for t in named.values())
    u = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    out, off = {}, 0
    for name, t in named.items():
        piece = u[off:off + t.numel()].view(t.shape)
        off += t.numel()
        if ".norms." in name:
            out[name] = (torch.ones_like(piece) if name.endswith("scale")
                         else torch.zeros_like(piece))
            continue
        v = piece * init_bound(name, named)
        if name.endswith("embed"):
            v = v / v.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        out[name] = v
    return out


def free_cuda():
    import gc
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
