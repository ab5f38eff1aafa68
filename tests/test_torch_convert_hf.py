"""PyTorch port vs the JAX package: HF -> native conversion
(utils/convert_hf.py, cli/convert.py), on config-built HF models (OPT,
LLaMA, Llama-3 style with rope_theta and tied embeddings, GQA).

The port's config must equal JAX's field by field and its params JAX's
convert output leaf by leaf, exactly; the port's DecoderLM logits must
match the HF model's to 1e-3; a checkpoint the port writes must load in
JAX's load_checkpoint; cli.convert.main --name reads a model saved to a
local directory."""
import dataclasses
import json

import numpy as np
import pytest
import torch
import transformers

from spt_proto_tpu.utils import checkpoint as jckpt
from spt_proto_tpu.utils import convert_hf as jconvert
from spt_proto_tpu.utils.tree import flatten as jflatten
from spt_proto_tpu_torch.inference.bridge import config_from
from spt_proto_tpu_torch.models.decoder import DecoderLM
from spt_proto_tpu_torch.utils import checkpoint as tckpt
from spt_proto_tpu_torch.utils import convert_hf as tconvert
from spt_proto_tpu_torch.utils.tree import flatten, to_numpy

torch.set_num_threads(1)

LLAMA = dict(hidden_size=64, num_hidden_layers=2, intermediate_size=128,
             num_attention_heads=4, max_position_embeddings=64,
             vocab_size=128)
# (name, HF model class, config, torch seed) as tests/test_convert_hf.py
CASES = {
    'opt': (transformers.OPTForCausalLM, transformers.OPTConfig(
        hidden_size=64, num_hidden_layers=2, ffn_dim=128,
        num_attention_heads=4, max_position_embeddings=64, vocab_size=128,
        do_layer_norm_before=True, dropout=0.0, activation_function='relu',
        word_embed_proj_dim=64), 0),
    'llama': (transformers.LlamaForCausalLM, transformers.LlamaConfig(
        num_key_value_heads=4, **LLAMA), 1),
    'llama3': (transformers.LlamaForCausalLM, transformers.LlamaConfig(
        num_key_value_heads=2, rope_theta=500000.0,
        tie_word_embeddings=True, **LLAMA), 3),
    'llama_gqa': (transformers.LlamaForCausalLM, transformers.LlamaConfig(
        num_key_value_heads=2, **LLAMA), 2),
}


def hf_model(name):
    cls, cfg, seed = CASES[name]
    torch.manual_seed(seed)
    return cls(cfg).eval()


@pytest.mark.parametrize('name', sorted(CASES))
def test_convert_matches_jax_and_hf(name, tmp_path):
    hf = hf_model(name)
    cfg, params = tconvert.convert(hf, 'cpu')
    jcfg, jparams = jconvert.convert(hf)
    assert cfg == config_from(jcfg)
    if name == 'llama3':
        assert cfg.rope_base == 500000.0 and cfg.n_kv_heads == 2
    flat, jflat = flatten(params), jflatten(jparams)
    assert sorted(flat) == sorted(jflat)
    for path, leaf in flat.items():
        assert leaf.dtype == torch.float32 and leaf.is_contiguous(), path
        np.testing.assert_array_equal(leaf.numpy(), jflat[path],
                                      err_msg=path)
    tokens = np.random.RandomState(CASES[name][2]).randint(
        0, 128, size=(2, 16)).astype(np.int64)
    with torch.no_grad():
        ours = DecoderLM(cfg, params)(torch.from_numpy(tokens))['logits']
        theirs = hf(torch.from_numpy(tokens)).logits
    np.testing.assert_allclose(ours.numpy(), theirs.numpy(), atol=1e-3)
    # a checkpoint the port writes loads in the JAX package
    tckpt.save_checkpoint(str(tmp_path / 'ck'), cfg, params)
    jcfg2, jparams2 = jckpt.load_checkpoint(str(tmp_path / 'ck'))
    assert jcfg2 == jcfg
    for path, leaf in jflatten(jparams2).items():
        np.testing.assert_array_equal(leaf, jflat[path], err_msg=path)


def test_convert_refuses_unconsumed_weights_and_other_models():
    hf = hf_model('opt')
    sd = dict(hf.state_dict(), **{'model.decoder.extra.weight':
                                  torch.zeros(2)})
    stub = type('Stub', (), {'config': hf.config,
                             'state_dict': lambda self: sd})()
    with pytest.raises(KeyError, match='unconsumed'):
        tconvert.convert(stub, 'cpu')
    gpt2 = transformers.GPT2Config(n_embd=64, n_layer=1, n_head=4)
    with pytest.raises(ValueError, match='unsupported model type'):
        tconvert.config_from_hf(gpt2)


@pytest.mark.parametrize('name', ['opt', 'llama_gqa'])
def test_convert_cli_reads_a_local_directory(name, tmp_path, capsys):
    from spt_proto_tpu_torch.cli import convert
    src = tmp_path / 'hf'
    hf_model(name).save_pretrained(str(src))
    out = str(tmp_path / 'native')
    cfg, params = convert.main(['--name', str(src), '--out', out,
                                '--device', 'cpu'])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith('[convert] parity') and \
        lines[0].endswith('OK'), lines
    jcfg, jparams = jckpt.load_checkpoint(out)
    assert config_from(jcfg) == cfg
    for path, leaf in jflatten(jparams).items():
        np.testing.assert_array_equal(leaf, to_numpy(flatten(params)[path]))
    with open(f'{out}/config.json') as f:
        assert json.load(f)['arch'] == cfg.arch
    assert dataclasses.asdict(cfg)['p_dropout'] == 0.0
