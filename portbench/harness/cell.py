"""One run of one cell: set-up, the measured window, the metrics and the
comparison.

Set-up (counted in ``setup_s``): the models' weights made on the device
from the seed, the server built as the configuration states, the set-up
solves (one fresh variant of every template, or every variant the mix
sends), then a short warm-up ``serve`` of requests outside the window.
The window is one ``OptimizerServer.serve`` of the mix's stream: its
arrivals advance the server's clock, and the server charges the measured
wall time of every flush and fusion round to it.  After the window the
reference judges what the window produced.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.models.gtn import GTNConfig
from repro_torch.core.models.perf_model import ModelConfig, PerfModel
from repro_torch.core.moo.hmooc import HMOOCConfig
from repro_torch.serve.runtime import RuntimeSession
from repro_torch.serve.server import OptimizerServer, ServerConfig
from repro_torch.serve.service import TuningService

from . import correct, devtrace, traffic
from .bench import Benchmark, QuerySource, metric_module
from .probe import Probe

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Record:
    """What a run leaves for the metric readers and the comparison."""
    cell: str
    served: list
    stats: object
    spans: Dict[str, list]
    samples: object
    window_s: float
    setup_s: float
    widths: dict
    trace: Optional[devtrace.TraceSummary] = None


def model_configs(cfg: dict) -> Dict[str, ModelConfig]:
    m = cfg["models"]
    gtn = GTNConfig(**m["gtn"])
    return {kind: ModelConfig(kind, spec["theta_dim"], gtn,
                              tuple(spec["hidden"]), spec["n_targets"])
            for kind, spec in m["heads"].items()}


def make_weights(cfgs: Dict[str, ModelConfig], model_seed: int, device):
    """The models' leaves, made on ``device``.

    The configuration fixes the model, as a deployment serves one: every
    leaf comes from one draw under ``model_seed`` (a dense weight
    N(0, 1/d_in), the positional projection half that; biases,
    attention-structure biases and layer-norm offsets N(0, 0.01); layer-norm
    gains 1 + N(0, 0.01); float32).  A run's seed varies its traffic, not
    the model.  Returns the device tensors, one dict a model, and their
    float64 host copies for the reference."""
    shapes = {kind: {k: tuple(v.shape) for k, v in
                     PerfModel(c, device="cpu").net.state_dict().items()}
              for kind, c in cfgs.items()}
    total = sum(int(np.prod(s)) for sh in shapes.values()
                for s in sh.values())
    gen = torch.Generator(device=device).manual_seed(int(model_seed))
    z = torch.randn(total, generator=gen, device=device,
                    dtype=torch.float32)
    dev, host, off = {}, {}, 0
    for kind, sh in shapes.items():
        w = {}
        for name, shape in sh.items():
            n = int(np.prod(shape))
            x = z[off:off + n].view(shape)
            off += n
            if name.endswith(".w"):
                x = x * ((0.5 if "pe_proj" in name else 1.0)
                         / np.sqrt(shape[0]))
            elif name.endswith(".g"):
                x = 1.0 + 0.1 * x
            else:
                x = 0.1 * x
            w[name] = x
        dev[kind] = w
        host[kind] = {k: v.double().cpu().numpy() for k, v in w.items()}
    return dev, host


def build_server(cfg: dict, models: Dict[str, PerfModel], device
                 ) -> OptimizerServer:
    rt = cfg["runtime"]
    tuning = TuningService(model=models["subq"],
                           cfg=HMOOCConfig(**cfg["hmooc"]), device=device)
    session = RuntimeSession(model_subq=models["subq"], model_qs=models["qs"],
                             weights=tuple(cfg["weights"]),
                             n_candidates=rt["n_candidates"], seed=rt["seed"],
                             gamma_mode=rt["gamma_mode"], device=device)
    return OptimizerServer(config=ServerConfig(**cfg["server"]),
                           tuning=tuning, session=session)


def widths(cfg: dict, cfgs: Dict[str, ModelConfig]) -> dict:
    g = cfgs["subq"].gtn
    return {"feat_dim": g.feat_dim, "pe_dim": g.pe_dim, "d_model": g.d_model,
            "n_heads": g.n_heads, "n_layers": g.n_layers, "d_ff": g.d_ff,
            "reg_in": cfgs["subq"].reg_in, "hidden": cfgs["subq"].hidden,
            "n_targets": cfgs["subq"].n_targets}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def setup(cfg: dict, mix: dict, queries: QuerySource, seed: int,
          seconds: float, device):
    """Models, server and traffic of one run, warmed up (set-up);
    ``queries`` is the configuration's ``Benchmark.queries``."""
    cfgs = model_configs(cfg)
    dev_w, host_w = make_weights(cfgs, cfg["models"]["model_seed"], device)
    models = {kind: PerfModel(c, params=dev_w[kind], device=device)
              for kind, c in cfgs.items()}
    del dev_w
    srv = build_server(cfg, models, device)
    tr = traffic.build(mix, queries, seed, seconds, cfg["query_seed"])
    step = srv.config.max_batch
    tenants = ["default"] * step
    for lo in range(0, len(tr.setup), step):
        batch = tr.setup[lo:lo + step]
        srv.tuning.tune_batch(batch, tuple(cfg["weights"]),
                              tenants=tenants[:len(batch)])
    srv.serve(tr.warmup)
    sync(device)
    return srv, models, host_w, tr, cfgs


def window(srv, models, tr, seed: int, trace: bool, sample: dict, device):
    """The measured serve, with the harness's spans on."""
    probe = Probe(srv, models["subq"], seed, sample)
    probe.install()
    prof = devtrace.profiler() if trace else contextlib.nullcontext()
    # Set-up's objects leave the collector's generations, so a collection
    # inside the window scans only what the window makes.
    gc.collect()
    gc.freeze()
    try:
        with prof:
            off = devtrace.clock_offset_ns()
            t0 = time.perf_counter()
            served = srv.serve(tr.window)
            sync(device)
            t1 = time.perf_counter()
    finally:
        probe.remove()
        gc.unfreeze()
    summary = None
    if trace:
        ns = lambda t: int(t * 1e9) + off  # noqa: E731
        summary = devtrace.summarize(
            devtrace.device_events(prof), (ns(t0), ns(t1)),
            [(ns(sp.t0), ns(sp.t1), name)
             for name, spans in probe.spans.items() for sp in spans])
    return served, probe, t0, t1, summary


def run(bench: Benchmark, cell_name: str, seed: int, seconds: float,
        trace: bool, device, t_start: float, overrides: Optional[dict] = None
        ):
    """One run: the result line's fields (``checks`` last) and the
    record."""
    cell = bench.cell(cell_name)
    cfg = bench.config(cell["config"])
    for key, val in (overrides or {}).items():
        cfg[key] = {**cfg[key], **val} if isinstance(val, dict) else val
    mix = bench.traffic(cell["traffic"])
    srv, models, host_w, tr, cfgs = setup(cfg, mix, bench.queries(cfg), seed,
                                          seconds, device)
    served, probe, t0, t1, summary = window(srv, models, tr, seed, trace,
                                            cfg["check"]["sample"], device)
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {found}")
    rec = Record(cell=cell_name, served=served, stats=srv.last_run,
                 spans=probe.spans, samples=probe.samples, window_s=t1 - t0,
                 setup_s=t0 - t_start, widths=widths(cfg, cfgs),
                 trace=summary)
    metrics = {}
    for m in bench.metrics(cell_name, trace):
        mod = metric_module(m["name"])
        if mod.UNIT != m["unit"]:
            raise ValueError(f"metric {m['name']}: unit {mod.UNIT!r} in its "
                             f"file, {m['unit']!r} in BENCHMARK.json")
        v = mod.read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    # The program's state goes before the reference runs.
    del srv, models, probe
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    values = correct.readings(rec, host_w, cfg)
    ok, checks = correct.verdict(values, cfg["check"]["limits"])
    failed = sum(s.status in correct.REJECTED or s.result is None
                 for s in served)
    out = {"correct": ok, "attempted": len(served), "failed": int(failed),
           "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": (torch.cuda.get_device_name(0) if cuda
                               else "cpu"),
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if summary is not None:
        out["device"]["busy_s"] = summary.busy_s
        out["device"]["window_s"] = summary.window_s
        out["breakdown"] = {"device_ops": summary.device_ops,
                            "idle_gaps": summary.idle_gaps}
    out["checks"] = checks
    return out, rec
