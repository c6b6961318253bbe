"""The port's training entry points on the CPU, at small sizes: the main
path's pre-training (``launch/collab_serve.py --reduced --pretrain N``, the
example's 150 steps cut to 40) lowers the loss and then serves, and the
``examples/train_lm.py`` twin (``launch/train_lm.py``) writes the
reference's CSV columns and a checkpoint that reloads into the model."""
import csv

import torch

from repro_torch.ckpt import load_checkpoint
from repro_torch.configs import get_config
from repro_torch.launch import collab_serve, train_lm
from repro_torch.weights import from_jax_params, to_reference_tree

torch.set_num_threads(1)   # tiny CPU ops: more threads only contend with the other test workers


def test_example_config_is_the_examples():
    cfg = collab_serve.example_config(get_config("qwen3-1.7b"))
    assert (cfg.n_layers, cfg.d_model, cfg.vocab_size, cfg.block_pattern) == (4, 256, 512,
                                                                              ("dense",))
    ssm = collab_serve.example_config(get_config("mamba2-1.3b"))
    assert ssm.block_pattern == ("mamba2",) and ssm.ssm.chunk == 16


def test_reduced_pretraining_lowers_the_loss_and_serves():
    res = collab_serve.main(["--reduced", "--pretrain", "40", "--requests", "2", "--seq", "16",
                             "--device", "cpu"])
    losses = [float(v) for v in res.train_losses]
    assert len(losses) == 40 and losses[0] > 5.5            # about log 512 at the start
    assert sum(losses[-5:]) / 5 < losses[0] - 0.25        # 6.27 -> 5.89 at seed 0
    assert len(res.stats) == 2
    for st, tokens in zip(res.stats, res.requests):
        assert st["logits_finite"] and st["logits_shape"] == (4, 16, 512)
        assert tokens.shape == (4, 16) and 0.0 <= st["top1_agree"] <= 1.0
        assert st["rate_R"] == 16.0


def test_train_lm_writes_its_csv_and_a_checkpoint_that_reloads(tmp_path):
    model, rows = train_lm.train(steps=10, layers=2, d_model=64, vocab=256, seq=16, batch=2,
                                 out=str(tmp_path), device="cpu", log=lambda *_: None)
    with open(tmp_path / "metrics.csv") as f:
        table = list(csv.DictReader(f))
    assert list(table[0]) == ["step", "loss", "ce", "grad_norm", "lr", "ms_per_step"]
    assert [int(r["step"]) for r in table] == [1, 10] == [r["step"] for r in rows]
    assert float(table[0]["lr"]) == 0.0 and float(table[1]["lr"]) > 0.0
    like = to_reference_tree(model)
    tree, meta = load_checkpoint(str(tmp_path / "final"), like)
    assert meta["step"] == 10 and meta["extra"] == {"config": model.cfg.name}
    again = from_jax_params(tree, model.cfg, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(again.parameters(), model.parameters()))
