"""The port's checkpoint loaders vs the JAX package's on a tiny Llama
checkpoint in HF's format written locally (no downloads): identical arrays,
identical spec."""

import dataclasses
import json

import numpy as np
import pytest

from bloombee_tpu.models import checkpoint as j_ckpt
from bloombee_tpu_torch.models import checkpoint as t_ckpt


@pytest.fixture(scope="module")
def tiny_model_dir(tmp_path_factory):
    """A 3-layer Llama in HF's on-disk format (config.json +
    model.safetensors with HF's tensor names), random f32."""
    from safetensors.numpy import save_file

    rng = np.random.default_rng(0)
    d, i, h, kv, hd, vocab = 64, 128, 4, 2, 16, 128
    shapes = {
        "input_layernorm.weight": (d,),
        "post_attention_layernorm.weight": (d,),
        "self_attn.q_proj.weight": (h * hd, d),
        "self_attn.k_proj.weight": (kv * hd, d),
        "self_attn.v_proj.weight": (kv * hd, d),
        "self_attn.o_proj.weight": (d, h * hd),
        "mlp.gate_proj.weight": (i, d),
        "mlp.up_proj.weight": (i, d),
        "mlp.down_proj.weight": (d, i),
    }
    tensors = {
        f"model.layers.{layer}.{key}": rng.standard_normal(shape)
        for layer in range(3)
        for key, shape in shapes.items()
    }
    tensors["model.embed_tokens.weight"] = rng.standard_normal((vocab, d))
    tensors["model.norm.weight"] = rng.standard_normal((d,))
    tensors["lm_head.weight"] = rng.standard_normal((vocab, d))
    out = tmp_path_factory.mktemp("tiny_llama_torch")
    save_file(
        {k: v.astype(np.float32) for k, v in tensors.items()},
        str(out / "model.safetensors"),
    )
    # the config.json `LlamaForCausalLM.save_pretrained` writes for this
    # model (transformers 4.57); importing transformers here would cost
    # more than the rest of the port's tests together
    (out / "config.json").write_text(json.dumps({
        "architectures": ["LlamaForCausalLM"], "attention_bias": False,
        "attention_dropout": 0.0, "bos_token_id": 1, "dtype": "float32",
        "eos_token_id": 2, "head_dim": hd, "hidden_act": "silu",
        "hidden_size": d, "initializer_range": 0.02,
        "intermediate_size": i, "max_position_embeddings": 256,
        "mlp_bias": False, "model_type": "llama",
        "num_attention_heads": h, "num_hidden_layers": 3,
        "num_key_value_heads": kv, "pretraining_tp": 1,
        "rms_norm_eps": 1e-05, "rope_scaling": None, "rope_theta": 10000.0,
        "tie_word_embeddings": False, "transformers_version": "4.57.6",
        "use_cache": True, "vocab_size": vocab,
    }))
    return str(out)


def test_load_spec_matches_jax(tiny_model_dir):
    port = dataclasses.asdict(t_ckpt.load_spec(tiny_model_dir))
    ref = dataclasses.asdict(j_ckpt.load_spec(tiny_model_dir))
    assert port == ref


def test_load_span_params_matches_jax(tiny_model_dir):
    layers, spec = t_ckpt.load_span_params(tiny_model_dir, 1, 3, device="cpu")
    stacked, _ = j_ckpt.load_span_params(tiny_model_dir, 1, 3)
    assert len(layers) == 2 and spec.num_hidden_layers == 3
    for name, arr in stacked.items():
        for i in range(2):
            np.testing.assert_array_equal(
                layers[i][name].numpy(), np.asarray(arr[i])
            )


def test_load_client_params_matches_jax(tiny_model_dir):
    port = t_ckpt.load_client_params(tiny_model_dir, device="cpu")
    ref = j_ckpt.load_client_params(tiny_model_dir)
    assert set(port) == set(ref)
    for name in ref:
        np.testing.assert_array_equal(port[name].numpy(), np.asarray(ref[name]))
