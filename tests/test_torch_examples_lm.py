"""``repro_torch.examples.serve_lm`` and ``train_lm`` on the CPU
(``--device cpu``: the oracles, the reduced config): the server answers
every request, and a short training run with a failure injected half way
restores the last checkpoint and finishes."""
import pytest

from repro_torch.examples import serve_lm, train_lm


def test_serve_lm_answers_every_request(capsys):
    serve_lm.main(["--device", "cpu", "--arch", "qwen2-0.5b"])
    out = capsys.readouterr().out
    assert "[serve] 12 requests, 192 tokens" in out


def test_train_lm_recovers_from_the_injected_failure(tmp_path, capsys):
    train_lm.main(["--device", "cpu", "--small", "--steps", "6", "--checkpoint-every", "2",
                   "--checkpoint-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "failure at step 3" in out and "restored step 2" in out
    assert "[train] done" in out


def test_the_examples_default_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would run")
    with pytest.raises(RuntimeError):
        serve_lm.main([])
    with pytest.raises(RuntimeError):
        train_lm.main(["--small", "--steps", "2"])
