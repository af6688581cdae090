"""The port's serving command line, ``repro_torch.launch.serve``, on the CPU.

``main`` serves every architecture in ``configs`` at its reduced size on
``--device cpu``: it prints the reference's ``[serve]`` line and returns
tokens inside the vocab.  ``serve`` given the JAX package's weights
(``init_params`` at ``PRNGKey(0)``, carried over by ``params_from_numpy``)
and JAX's prompt (``randint`` at ``PRNGKey(1)``), as
``repro/launch/serve.py`` draws them, returns the JAX engine's greedy
tokens for the families whose port engine is already held equal to JAX's
(dense, moe, ssm; vlm with the reference's zero embeds).  Whisper is held
to a loop of JAX's ``decode_step`` at ``T + i`` (the JAX engine counts the
encoder frames into the decode position: ROADMAP §3).  Token comparisons
are exact.  The command line refuses an out-of-vocab token and, with no
card and no ``--device cpu``, refuses to run."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import whisper as j_whisper
from repro.models.api import get_model as j_get_model
from repro.serve import Engine as JEngine
from repro.serve.engine import _pad_cache as j_pad_cache
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.launch import serve as t_serve
from repro_torch.models.convert import params_from_numpy
from repro_torch.mpc.errors import InvariantError

B, T, NEW = 2, 8, 4


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_main_serves_every_arch_on_the_cpu(arch, capsys):
    out = t_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                        "--batch", "3", "--prompt-len", "6", "--max-new",
                        "5"])
    line = capsys.readouterr().out
    assert line.startswith("[serve] generated (3, 5) in ") and "tok/s" in line
    cfg = reduced(get_config(arch))
    assert out.shape == (3, 5) and out.dtype == torch.int64
    assert out.device.type == "cpu"
    assert int(out.min()) >= 0 and int(out.max()) < cfg.vocab
    # the same seeds give the same tokens
    again = t_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                          "--batch", "3", "--prompt-len", "6", "--max-new",
                          "5"])
    assert torch.equal(out, again)


def test_main_draws_the_prompt_and_stubs_as_documented():
    cfg = reduced(get_config("phi-3-vision-4.2b"))
    _, prompt, embeds = t_serve.inputs(cfg, 2, 5, "cpu")
    g = torch.Generator()
    g.manual_seed(t_serve.PROMPT_SEED)
    assert torch.equal(prompt, torch.randint(0, cfg.vocab, (2, 5),
                                             generator=g))
    assert embeds.shape == (2, cfg.frontend_positions, cfg.d_model)
    assert embeds.dtype == torch.float32 and not embeds.any()
    cfg = reduced(get_config("whisper-small"))
    _, _, frames = t_serve.inputs(cfg, 2, 5, "cpu")
    assert frames.shape == (2, 5, cfg.d_model)
    assert frames.dtype == torch.float32 and not frames.any()
    _, _, none = t_serve.inputs(reduced(get_config("llama3.2-1b")), 2, 5,
                                "cpu")
    assert none is None


def _jax_inputs(arch):
    cfg = j_reduced(j_get_config(arch))
    jp = j_get_model(cfg).init_params(cfg, jax.random.PRNGKey(0))
    prompt = jax.random.randint(jax.random.PRNGKey(1), (B, T), 0, cfg.vocab)
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp, prompt


@pytest.mark.parametrize("arch", ["llama3.2-1b", "olmoe-1b-7b", "rwkv6-1.6b",
                                  "phi-3-vision-4.2b"])
def test_serve_equals_the_jax_engine(arch):
    cfg, jp, tp, prompt = _jax_inputs(arch)
    embeds = j_embeds = None
    if cfg.family == "vlm":
        j_embeds = jnp.zeros((B, cfg.frontend_positions, cfg.d_model),
                             jnp.float32)
        embeds = torch.zeros((B, cfg.frontend_positions, cfg.d_model))
    want = JEngine(cfg, jp).generate(prompt, NEW, embeds=j_embeds)
    got, seconds = t_serve.serve(cfg, tp, np.array(prompt), NEW,
                                 embeds=embeds, device="cpu")
    assert seconds > 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_whisper_equals_a_jax_decode_step_loop():
    cfg, jp, tp, prompt = _jax_inputs("whisper-small")
    frames = np.zeros((B, T, cfg.d_model), np.float32)
    got, _ = t_serve.serve(cfg, tp, np.array(prompt), NEW,
                           embeds=torch.from_numpy(frames), device="cpu")
    logits, cache = j_whisper.prefill(cfg, jp, prompt,
                                      embeds=jnp.asarray(frames))
    cache = j_pad_cache(cache, NEW - 1)
    nxt = jnp.argmax(logits[:, -1:], axis=-1)
    want = [nxt]
    for i in range(NEW - 1):
        logits, cache = j_whisper.decode_step(cfg, jp, cache, nxt,
                                              jnp.int32(T + i))
        nxt = jnp.argmax(logits[:, -1:], axis=-1)
        want.append(nxt)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.concatenate(want, axis=1)))


def test_main_refuses_an_out_of_vocab_token(monkeypatch):
    cfg = reduced(get_config("llama3.2-1b"))

    def bad_serve(cfg_, params, prompt, max_new, **kw):
        return torch.full((prompt.shape[0], max_new), cfg.vocab), 1.0

    monkeypatch.setattr(t_serve, "serve", bad_serve)
    with pytest.raises(InvariantError, match=f"outside vocab {cfg.vocab}"):
        t_serve.main(["--reduced", "--device", "cpu"])


def test_main_defaults_to_the_card_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_serve.main(["--reduced"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_serve.serve(reduced(get_config("llama3.2-1b")), None,
                      np.zeros((1, 2), np.int64), 1)
