"""The port's checkpoint converters (models/convert.py) and their callers
against the JAX package's, on the CPU at tiny sizes, on checkpoints the
tests write themselves (nothing is downloaded):

- ``hf_config_to_lm_config`` on a Llama dict (llama3 rope scaling, tied
  embeddings) and a Qwen2 dict (``attention_bias``): field for field;
- ``load_hf_llama`` on a directory of two ``.safetensors`` shards mixing bf16
  and f32 (written with ``safetensors.torch.save_file``, test side only) and
  on a ``pytorch_model.bin``: the config field for field, every leaf bit for
  bit; the port's own safetensors reader against ``safe_open`` per dtype;
- ``resize_embeddings``: old rows bit for bit, new rows around the old mean;
- ``RealtimeAgentResources(llm_model_path=<HF dir>, codec_model=<npz>)`` in
  both packages: the same config and three greedy chunks of the same ids;
- the port CLI's ``--init_from <HF dir>`` and the TTS server's
  ``--codec_checkpoint`` on the CPU;
- the converters need neither safetensors nor transformers (the card's
  machine has neither).
"""
import dataclasses
import json
import pathlib
import re
import struct
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from realtime_codec_agent_tpu.agent.agent import RealtimeAgent as JaxAgent
from realtime_codec_agent_tpu.agent.config import RealtimeAgentConfig as JaxConfig
from realtime_codec_agent_tpu.agent.resources import RealtimeAgentResources as JaxResources
from realtime_codec_agent_tpu.models import convert as jconvert
from realtime_codec_agent_tpu.models.codec import JaxCodecModel, tiny_codec_config
from realtime_codec_agent_tpu_torch import train_duplex_lm as tcli
from realtime_codec_agent_tpu_torch.agent.agent import RealtimeAgent
from realtime_codec_agent_tpu_torch.agent.config import RealtimeAgentConfig
from realtime_codec_agent_tpu_torch.agent.resources import RealtimeAgentResources
from realtime_codec_agent_tpu_torch.models import convert as tconvert
from realtime_codec_agent_tpu_torch.models import llama as tl
from realtime_codec_agent_tpu_torch.serving import tts_server as ttts
from realtime_codec_agent_tpu_torch.tokenization import CodecTextTokenizer
from realtime_codec_agent_tpu_torch.train import checkpoint as ckpt

from test_torch_codec import assert_tree_equal
from test_torch_gguf import CONFIG, _pinned
from test_torch_pipeline import one_torch_thread  # noqa: F401 (a module fixture)

H, FFN, LAYERS, HEADS, KV, DH = 64, 128, 2, 4, 2, 16


def hf_config(vocab: int, tie: bool, qwen: bool = False) -> dict:
    cfg = {
        "architectures": ["Qwen2ForCausalLM" if qwen else "LlamaForCausalLM"],
        "model_type": "qwen2" if qwen else "llama",
        "vocab_size": vocab, "hidden_size": H, "intermediate_size": FFN, "num_hidden_layers": LAYERS,
        "num_attention_heads": HEADS, "num_key_value_heads": KV, "head_dim": DH, "rope_theta": 500000.0,
        "rms_norm_eps": 1e-5, "tie_word_embeddings": tie, "torch_dtype": "bfloat16",
    }
    if qwen:
        cfg.update(attention_bias=True, rope_theta=1000000.0, rms_norm_eps=1e-6)
        del cfg["head_dim"]
    else:
        cfg["rope_scaling"] = {"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
                               "high_freq_factor": 4.0, "original_max_position_embeddings": 64}
    return cfg


def hf_state_dict(cfg: dict, seed: int) -> dict:
    """An LlamaForCausalLM / Qwen2ForCausalLM state dict from a numpy seed:
    layer weights bf16, embeddings and norms f32."""
    rng = np.random.default_rng(seed)
    qwen = cfg["model_type"] == "qwen2"
    dh = cfg.get("head_dim", H // HEADS)

    def t(*shape, s=0.05, dtype=torch.bfloat16):
        return torch.from_numpy((rng.normal(size=shape) * s).astype(np.float32)).to(dtype)

    sd = {"model.embed_tokens.weight": t(cfg["vocab_size"], H, dtype=torch.float32),
          "model.norm.weight": 1 + t(H, s=0.1, dtype=torch.float32)}
    for i in range(LAYERS):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = 1 + t(H, s=0.1, dtype=torch.float32)
        sd[p + "post_attention_layernorm.weight"] = 1 + t(H, s=0.1, dtype=torch.float32)
        for name, rows in (("q", HEADS * dh), ("k", KV * dh), ("v", KV * dh)):
            sd[p + f"self_attn.{name}_proj.weight"] = t(rows, H)
            if qwen:
                sd[p + f"self_attn.{name}_proj.bias"] = t(rows)
        sd[p + "self_attn.o_proj.weight"] = t(H, HEADS * dh)
        sd[p + "mlp.gate_proj.weight"] = t(FFN, H)
        sd[p + "mlp.up_proj.weight"] = t(FFN, H)
        sd[p + "mlp.down_proj.weight"] = t(H, FFN)
    if not cfg["tie_word_embeddings"]:
        sd["lm_head.weight"] = t(cfg["vocab_size"], H, dtype=torch.float32)
    return sd


def write_hf_dir(path: pathlib.Path, cfg: dict, seed: int, form: str = "safetensors") -> dict:
    """config.json + two safetensors shards (layer 0 and the embedding in the
    first) or a pytorch_model.bin."""
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(cfg))
    sd = hf_state_dict(cfg, seed)
    if form == "bin":
        torch.save(sd, path / "pytorch_model.bin")
    else:
        from safetensors.torch import save_file

        first = {k: v for k, v in sd.items() if "layers.0." in k or "embed" in k}
        save_file(first, str(path / "model-00001-of-00002.safetensors"))
        save_file({k: v for k, v in sd.items() if k not in first}, str(path / "model-00002-of-00002.safetensors"))
    return sd


@pytest.mark.parametrize("family", ["llama", "qwen2"])
def test_hf_config_matches_jax(family):
    cfg = hf_config(1000, tie=family == "llama", qwen=family == "qwen2")
    want = jconvert.hf_config_to_lm_config(cfg, max_context=64, codec_vocab_start=300)
    got = tconvert.hf_config_to_lm_config(cfg, max_context=64, codec_vocab_start=300)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if family == "llama":
        assert got.tie_embeddings and got.rope_scaling == (32.0, 1.0, 4.0, 64) and not got.attn_bias
    else:
        assert got.attn_bias and got.head_dim == H // HEADS and got.rope_scaling is None


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("form", ["safetensors", "bin"])
def test_load_hf_llama_matches_jax(tmp_path, form, tie):
    """The config field for field and every leaf bit for bit (bf16, the
    config's compute dtype); the tensors reach the converter in their
    checkpoint dtype."""
    cfg = hf_config(96, tie=tie, qwen=form == "bin" and tie)
    write_hf_dir(tmp_path, cfg, seed=3, form=form)
    jparams, jcfg = jconvert.load_hf_llama(str(tmp_path), max_context=64)
    tparams, tcfg = tconvert.load_hf_llama(str(tmp_path), max_context=64)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert_tree_equal(tparams, jax.tree_util.tree_map(np.asarray, jparams))
    assert ("lm_head" in tparams) == (not tie)
    f32, _ = tconvert.load_hf_llama(str(tmp_path), dtype=torch.float32, max_context=64)
    assert f32["layers"][1]["wq"].dtype == torch.float32


def test_safetensors_reader_matches_safe_open(tmp_path):
    """The port's reader against ``safe_open`` for F32, F16, BF16, I32, I64,
    U8 and BOOL (stored dtype kept, bit for bit), on a file of mixed dtypes and
    one whose odd-sized int8 tensor leaves an f32 tensor misaligned; an unknown
    dtype raises, naming the tensor."""
    from safetensors import safe_open
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(0)
    tensors = {
        "f32": torch.randn(3, 5, generator=g), "f16": torch.randn(7, generator=g).half(),
        "bf16": torch.randn(2, 3, 4, generator=g).bfloat16(), "i32": torch.arange(-5, 6, dtype=torch.int32),
        "i64": torch.arange(10) * (1 << 40), "u8": torch.arange(255, dtype=torch.uint8),
        "b": torch.tensor([True, False, True]), "scalar": torch.tensor(2.5), "empty": torch.zeros(0, 4),
    }
    path = str(tmp_path / "mixed.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got = tconvert.read_safetensors(path)
    with safe_open(path, framework="pt") as f:
        assert sorted(got) == sorted(f.keys())
        for name in f.keys():
            want = f.get_tensor(name)
            assert got[name].dtype == want.dtype and got[name].shape == want.shape, name
            assert torch.equal(got[name], want), name

    # a hand-written file: an int8 tensor of 3 bytes, then an f32 tensor
    f32 = np.arange(4, dtype="<f4")
    header = {"a": {"dtype": "I8", "shape": [3], "data_offsets": [0, 3]},
              "b": {"dtype": "F32", "shape": [4], "data_offsets": [3, 19]}}
    raw = json.dumps(header).encode()
    (tmp_path / "odd.safetensors").write_bytes(struct.pack("<Q", len(raw)) + raw + b"\x01\x02\xff" + f32.tobytes())
    odd = tconvert.read_safetensors(str(tmp_path / "odd.safetensors"))
    assert odd["a"].tolist() == [1, 2, -1] and odd["b"].tolist() == f32.tolist()

    save_file({"w": torch.zeros(2, dtype=torch.float8_e4m3fn)}, str(tmp_path / "f8.safetensors"))
    with pytest.raises(ValueError, match="'w'.*F8_E4M3"):
        tconvert.read_safetensors(str(tmp_path / "f8.safetensors"))


def test_resize_embeddings():
    """Old rows bit for bit; each new column's mean within 4 standard errors
    (0.02 / sqrt(new rows)) of the old mean; lm_head grows along axis 1;
    shrinking raises ValueError; the same seed gives the same rows."""
    g = torch.Generator().manual_seed(1)
    cfg = tl.tiny_lm_config(vocab_size=100)
    params = {"embed_tokens": torch.randn(100, H, generator=g) + 0.5, "lm_head": torch.randn(H, 100, generator=g)}
    out, cfg2 = tconvert.resize_embeddings(params, cfg, 1100, seed=4)
    assert cfg2.vocab_size == 1100 and out["embed_tokens"].shape == (1100, H) and out["lm_head"].shape == (H, 1100)
    assert torch.equal(out["embed_tokens"][:100], params["embed_tokens"])
    assert torch.equal(out["lm_head"][:, :100], params["lm_head"])
    se = 4 * 0.02 / np.sqrt(1000)
    assert (out["embed_tokens"][100:].mean(0) - params["embed_tokens"].mean(0)).abs().max() < se
    assert (out["lm_head"][:, 100:].mean(1) - params["lm_head"].mean(1)).abs().max() < se
    assert 0.015 < float(out["embed_tokens"][100:].std(0).mean()) < 0.025
    again, _ = tconvert.resize_embeddings(params, cfg, 1100, seed=4)
    assert torch.equal(again["embed_tokens"], out["embed_tokens"])
    with pytest.raises(ValueError, match="shrink"):
        tconvert.resize_embeddings(params, cfg, 99)


def test_resources_hf_directory_matches_jax(tmp_path):
    """Both packages' resources on one HF directory and one codec ``.npz``:
    the HF config adopted with the default codec start, the codec loaded by
    path, and three greedy chunks of the agent giving the same ids (the LM
    in bf16, the checkpoint config's; the codec in f32, whose codes are
    exact: a bf16 codec's codes agree on ~97% of frames, test_torch_codec's
    BF16_CODES, and one flipped user code changes the ids)."""
    vocab = CodecTextTokenizer(codebook_size=1024).vocab_size
    write_hf_dir(tmp_path / "hf", hf_config(vocab, tie=False), seed=5)
    codec = JaxCodecModel.random_init(tiny_codec_config(compute_dtype="float32"), seed=2)
    npz = str(tmp_path / "codec.npz")
    jconvert.save_codec_checkpoint(npz, codec.params, codec.config)
    kw = dict(llm_model_path=str(tmp_path / "hf"), codec_model=npz, tiny=True, whisper_model=None, llm_n_ctx=1024)
    jres = JaxResources(**kw)
    tres = RealtimeAgentResources(device="cpu", **kw)
    assert dataclasses.asdict(tres.lm_config) == dataclasses.asdict(jres.lm_config)
    assert tres.lm_config.vocab_size == vocab and tres.lm_config.hidden_size == H
    assert dataclasses.asdict(tres.audio_tokenizer.codec_model.config) == dataclasses.asdict(codec.config)
    jagent = _pinned(JaxAgent(resources=jres, config=JaxConfig(**CONFIG)), jres)
    tagent = _pinned(RealtimeAgent(resources=tres, config=RealtimeAgentConfig(**CONFIG)), tres)
    audio = (0.1 * np.random.default_rng(3).normal(size=3 * 1600)).astype(np.float32)
    for c in range(3):
        chunk = audio[c * 1600 : (c + 1) * 1600]
        jagent.process_audio(chunk)
        tagent.process_audio(chunk)
    assert tagent.input_ids == jagent.input_ids
    assert len(tagent.audio_tokens_idx) == len(jagent.audio_tokens_idx) > 0


def test_cli_init_from_hf_directory(tmp_path):
    """``--init_from <HF dir>`` on the CPU: the checkpoint converted, its
    embeddings resized to the tokenizer's vocab, the codec branch added, two
    training steps, the exported params at the new vocab."""
    write_hf_dir(tmp_path / "hf", hf_config(128, tie=False), seed=6)
    rng = np.random.default_rng(8)
    with open(tmp_path / "data.txt", "w", encoding="utf-8") as f:
        for i in range(8):
            codes = "".join(chr(0xE000 + int(c)) for c in rng.integers(0, 64, size=int(rng.integers(4, 20))))
            f.write(f"<|audio|>{codes}<|end_audio|> A: turn {i}\n")
    np.save(tmp_path / "codec.npy", rng.normal(size=(1, 64, 16)).astype(np.float32))
    out = tmp_path / "run"
    metrics = tcli.main([
        "--dataset", str(tmp_path / "data.txt"), "--output_dir", str(out), "--device", "cpu",
        "--init_from", str(tmp_path / "hf"), "--codec_embed_file", str(tmp_path / "codec.npy"),
        "--max_steps", "2", "--batch_size", "2", "--max_seq_len", "32", "--warmup_steps", "1",
        "--eval_split_every_n", "0", "--compute_dtype", "float32", "--log_every", "1",
    ])
    assert all(np.isfinite(v) for v in metrics.values())
    vocab = ((CodecTextTokenizer(codebook_size=64).vocab_size + 7) // 8) * 8
    info = json.loads((out / "train_config.json").read_text())
    assert info["vocab_size"] == vocab > 128
    params = ckpt.load_params(str(out / "params.torch"))
    assert params["embed_tokens"].shape == (vocab, H) and params["lm_head"].shape == (H, vocab)
    assert params["codec_embed"]["table"].shape == (64, 16)


def test_tts_server_loads_codec_checkpoint(tmp_path, monkeypatch):
    """``tts_server.main(["--codec_checkpoint", <npz>, "--device", "cpu"])``
    builds its tokenizer over the checkpoint's codec on the CPU."""
    codec = JaxCodecModel.random_init(tiny_codec_config(compute_dtype="float32"), seed=4)
    path = str(tmp_path / "codec.npz")
    jconvert.save_codec_checkpoint(path, codec.params, codec.config)
    built = {}

    class Httpd:
        server_address = ("127.0.0.1", 0)

        def serve_forever(self):
            pass

        def server_close(self):
            pass

    def fake_server(server, host, port):
        built["server"] = server
        return Httpd()

    monkeypatch.setattr(ttts, "make_http_server", fake_server)
    ttts.main(["--codec_checkpoint", path, "--device", "cpu", "--port", "0"])
    model = built["server"].audio_tokenizer.codec_model
    assert model.device == torch.device("cpu")
    assert dataclasses.asdict(model.config) == dataclasses.asdict(codec.config)
    assert_tree_equal(model.params, jax.tree_util.tree_map(np.asarray, codec.params))
    with pytest.raises(FileNotFoundError):
        ttts.main(["--codec_checkpoint", str(tmp_path / "nope.npz"), "--device", "cpu"])


def test_converters_need_no_safetensors_or_transformers(tmp_path):
    """In a fresh interpreter where importing jax, safetensors or
    transformers fails, every module of the port imports and the checkpoint
    paths run: load_hf_llama over a safetensors shard, a codec ``.npz`` and a
    torch state dict through TorchCodecModel.load. No source of the port
    imports safetensors; transformers only inside the two functions that
    load Hugging Face Whisper checkpoints and tokenizers."""
    from safetensors.torch import save_file

    write_hf_dir(tmp_path / "hf", hf_config(96, tie=True), seed=7)
    save_file({"x": torch.ones(2)}, str(tmp_path / "extra.safetensors"))
    codec = JaxCodecModel.random_init(tiny_codec_config(), seed=1)
    jconvert.save_codec_checkpoint(str(tmp_path / "codec.npz"), codec.params, codec.config)
    code = (
        "import sys, importlib, pkgutil\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'safetensors', 'transformers'):\n"
        "            raise ImportError(name + ' is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import torch\n"
        "import realtime_codec_agent_tpu_torch as p\n"
        "[importlib.import_module(m.name) for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "from realtime_codec_agent_tpu_torch.models import convert, codec\n"
        f"root = {str(tmp_path)!r}\n"
        "params, cfg = convert.load_hf_llama(root + '/hf', max_context=64)\n"
        "assert cfg.tie_embeddings and params['embed_tokens'].shape == (96, 64)\n"
        "assert convert.read_safetensors(root + '/extra.safetensors')['x'].tolist() == [1.0, 1.0]\n"
        "m = codec.TorchCodecModel.load(root + '/codec.npz', device='cpu')\n"
        "torch.save({'state_dict': {}}, root + '/empty.pt')\n"
        "try:\n"
        "    codec.TorchCodecModel.load(root + '/empty.pt', device='cpu')\n"
        "except KeyError as e:\n"
        "    assert 'no transformer blocks' in str(e)\n"
        "assert not [n for n in sys.modules if n.split('.')[0] in ('jax', 'safetensors', 'transformers')]\n"
        "print('ok', m.encode(__import__('numpy').zeros((1, 640), 'float32')).shape)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok (1, 2)")
    root = pathlib.Path(__file__).resolve().parents[1] / "realtime_codec_agent_tpu_torch"
    pattern = re.compile(r"^(\s*)(?:import|from)\s+(safetensors|transformers)\b", re.MULTILINE)
    sites = {}
    for f in root.rglob("*.py"):
        for indent, word in pattern.findall(f.read_text()):
            sites.setdefault(f"{f.relative_to(root)}:{word}", []).append(indent)
    assert set(sites) == {"agent/asr.py:transformers", "tokenization/tokenizer.py:transformers"}, sites
    assert all(indent for indents in sites.values() for indent in indents)  # inside functions only
