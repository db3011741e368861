"""HF checkpoint reading for the port, Llama only (port of
bloombee_tpu/models/checkpoint.py).

A server loads only its span's layers; a client loads only the embeddings,
the final norm and the LM head. Model directories are local paths
(config.json + *.safetensors [+ index]). `safetensors` is imported inside the
reader, so the package imports where it is not installed.
"""

from __future__ import annotations

import json
import pathlib

import torch

from bloombee_tpu_torch.models.llama.block import (
    HF_BLOCK_KEYS,
    convert_hf_block_params,
)
from bloombee_tpu_torch.models.llama.config import llama_spec_from_config_dict
from bloombee_tpu_torch.models.spec import ModelSpec
from bloombee_tpu_torch.utils.device import resolve_device


class CheckpointReader:
    """Lazy tensor reader over a local HF model directory."""

    def __init__(self, model_dir: str | pathlib.Path):
        from safetensors import safe_open

        self._safe_open = safe_open
        self.dir = pathlib.Path(model_dir)
        with open(self.dir / "config.json") as f:
            self.config = json.load(f)
        index_path = self.dir / "model.safetensors.index.json"
        if index_path.exists():
            with open(index_path) as f:
                self._weight_map = json.load(f)["weight_map"]
        else:
            files = sorted(self.dir.glob("*.safetensors"))
            if not files:
                raise FileNotFoundError(f"no safetensors in {self.dir}")
            self._weight_map = {}
            for fp in files:
                with safe_open(fp, framework="pt") as f:
                    for k in f.keys():
                        self._weight_map[k] = fp.name
        self._handles: dict[str, object] = {}

    def keys(self):
        return self._weight_map.keys()

    def has(self, name: str) -> bool:
        return name in self._weight_map

    def tensor(self, name: str) -> torch.Tensor:
        fname = self._weight_map[name]
        h = self._handles.get(fname)
        if h is None:
            h = self._safe_open(self.dir / fname, framework="pt")
            self._handles[fname] = h
        return h.get_tensor(name)

    def model_type(self) -> str:
        return self.config.get("model_type", "llama")


def _llama(reader: CheckpointReader) -> None:
    if reader.model_type() != "llama":
        raise NotImplementedError(
            f"the port loads llama checkpoints only, not "
            f"{reader.model_type()!r}"
        )


def load_spec(model_dir: str) -> ModelSpec:
    reader = CheckpointReader(model_dir)
    _llama(reader)
    return llama_spec_from_config_dict(reader.config)


def load_span_params(
    model_dir: str, start: int, end: int, dtype=None, device="cuda"
) -> tuple[list[dict], ModelSpec]:
    """Per-layer params for blocks [start, end) (a list of dicts) and the
    model's spec."""
    device = resolve_device(device)
    reader = CheckpointReader(model_dir)
    _llama(reader)
    layers = []
    for i in range(start, end):
        tensors = {
            key: reader.tensor(f"model.layers.{i}.{key}")
            for key in HF_BLOCK_KEYS
        }
        layers.append(
            convert_hf_block_params(tensors, dtype=dtype, device=device)
        )
    return layers, llama_spec_from_config_dict(reader.config)


def load_client_params(model_dir: str, dtype=None, device="cuda") -> dict:
    """Embeddings + final norm + LM head ([D, V]; the embedding's transpose
    when the checkpoint ties them)."""
    device = resolve_device(device)
    reader = CheckpointReader(model_dir)
    _llama(reader)
    embed = reader.tensor("model.embed_tokens.weight")
    norm = reader.tensor("model.norm.weight")
    if reader.has("lm_head.weight"):
        head = reader.tensor("lm_head.weight").t()
    else:  # tied embeddings
        head = embed.t()
    return {
        name: x.to(device=device, dtype=dtype).contiguous()
        for name, x in (("embed", embed), ("norm", norm), ("lm_head", head))
    }
