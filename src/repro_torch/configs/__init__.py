"""Architecture registry of the port (``repro/configs``): one module per
ported architecture, each exporting ``CONFIG`` (the published configuration)
and ``smoke_config()`` (a reduced same-family config for CPU tests).

``list_archs`` names every architecture of the reference; every one of
them is ported: the dense, moe, ssm, hybrid, vlm and audio families.
"""

from __future__ import annotations

import importlib

ARCHS = [
    "rwkv6-7b",
    "llama3.2-1b",
    "starcoder2-15b",
    "qwen2-1.5b",
    "deepseek-7b",
    "llama-3.2-vision-90b",
    "zamba2-1.2b",
    "kimi-k2-1t-a32b",
    "deepseek-v3-671b",
    "whisper-large-v3",
]

_MODULES = {name: name.replace("-", "_").replace(".", "_") for name in ARCHS}


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke_config(name: str):
    return _module(name).smoke_config()


def list_archs() -> list[str]:
    return list(ARCHS)
