"""The plain f32 reference of the benchmark's configurations: plain
PyTorch that imports nothing of the program. A configuration file names
its module here under ``reference`` (default ``model``, which holds the
ViT and the decoder LM); a module gives ``param_spec(cfg)``,
``forward(cfg, prec, params, inputs, telemetry=False)`` and ``loss(cfg,
prec, params, batch)``."""
import importlib


def module_of(cfg: dict):
    return importlib.import_module(
        f"port_bench.reference.{cfg.get('reference', 'model')}")
