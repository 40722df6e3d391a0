"""Fault-tolerance walkthrough: crash, restore, and ELASTIC restore with
the Hokusai sketch fold (paper §5).

    PYTHONPATH=src python examples_torch/elastic_recovery.py [--device cpu]

The PyTorch counterpart of ``examples/elastic_recovery.py``, on the card
unless ``--device cpu``:

1. trains with CS-Adam, checkpointing every 20 steps;
2. simulates a crash at step 50, restores at step 40, resumes: the
   losses equal the uninterrupted run's (deterministic zipf stream; the
   port adds colliding sums in a fixed order), or the script exits 1;
3. simulates losing a quarter of the fleet: ``plan_resize`` shrinks the
   data axis and asks for a sketch FOLD; the optimizer state halves
   while keeping the accumulated moments, and training continues.

The sketch stores run on backend 'auto': on a card the sketched tables'
moments go through the hand-written ``cs_ema_tiled`` kernel.
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.core import optimizers as O
from repro_torch.core.partition import SketchPolicy, leaf_paths
from repro_torch.core.transforms import tree_map_with_path
from repro_torch.data import ZipfLM, ZipfLMConfig
from repro_torch.distributed.elastic import plan_resize
from repro_torch.models import transformer as tf
from repro_torch.models.config import ArchConfig
from repro_torch.train.trainer import Trainer, TrainerConfig, TrainState

CFG = ArchConfig(name="demo", family="gqa", n_layers=2, d_model=128,
                 n_heads=4, n_kv=2, head_dim=32, d_ff=512, vocab_size=4096,
                 vocab_multiple=64, attn_chunk=64, loss_chunk=64,
                 compute_dtype="float32")
HP = O.SketchHParams(compression=4.0, width_multiple=16, backend="auto")
POL = SketchPolicy(min_rows=512)


def make_step(opt):
    def step_fn(params, st, batch):
        live = tree_map_with_path(
            lambda _p, x: x.detach().requires_grad_(True), params)
        leaves = leaf_paths(live)
        loss = tf.train_loss(CFG, live, batch, remat=False)
        grads = torch.autograd.grad(loss, [x for _p, x in leaves])
        by_path = {p: g for (p, _x), g in zip(leaves, grads)}
        g = tree_map_with_path(lambda p, _x: by_path[p], params)
        u, st = opt.update(g, st, params)
        return O.apply_updates(params, u), st, {"loss": loss.detach()}
    return step_fn


def make_pieces(dev):
    """The optimizer, a fresh start from seed 0, the step and the data
    (the step updates params and state in place: every run starts from
    its own copy)."""
    opt = O.countsketch_adam(1e-3, policy=POL, hparams=HP)
    params = tf.init(torch.Generator(device=dev).manual_seed(0), CFG,
                     device=dev)
    data = ZipfLM(ZipfLMConfig(vocab_size=CFG.vocab, seq_len=64,
                               global_batch=4))
    return opt, TrainState(0, params, opt.init(params)), make_step(opt), data


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu only when asked)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    print(f"device: {dev.type}"
          + (f" ({torch.cuda.get_device_name(dev)})"
             if dev.type == "cuda" else ""))

    if dev.type == "cpu":
        # the CPU build's multithreaded reductions add in an order that
        # changes from run to run; one thread repeats its bits, as the
        # card's fixed-order sums do
        torch.set_num_threads(1)
    # the uninterrupted run, the witness of part 1
    _opt, st0, step_fn, data = make_pieces(dev)
    whole = Trainer(step_fn, data, TrainerConfig(total_steps=60),
                    device=dev)
    whole.fit(st0)

    with tempfile.TemporaryDirectory() as d:
        opt, st0, step_fn, data = make_pieces(dev)
        tcfg = TrainerConfig(total_steps=60, ckpt_dir=d, ckpt_every=20,
                             ckpt_async=False)
        # --- crash + recovery --------------------------------------------
        tr = Trainer(step_fn, data, tcfg, fail_at=50, device=dev)
        try:
            tr.fit(st0)
        except RuntimeError as e:
            print(f"[1] simulated failure: {e}")
        resumed = tr.restore_or_init(st0)
        print(f"[1] restored at step {resumed.step}; resuming...")
        n_before = len(tr.history)
        out = tr.fit(resumed)
        got = [h["loss"] for h in tr.history[n_before:]]
        want = [h["loss"] for h in whole.history[resumed.step:]]
        same = got == want
        print(f"[1] finished at step {out.step}, "
              f"loss {tr.history[-1]['loss']:.3f}; steps "
              f"{resumed.step + 1}..{out.step} equal to the uninterrupted "
              f"run's: {same}")
        if not same:
            return 1

        # --- elastic resize + sketch fold ---------------------------------
        plan = plan_resize(available_chips=192, model_axis=16,
                           old_data_axis=16)
        print(f"[2] lost 64/256 chips -> new mesh data={plan.data_axis} "
              f"model={plan.model_axis}, fold_sketch={plan.fold_sketch}")
        before = O.state_bytes(out.opt_state)
        folded = store.fold_sketches({"opt_state": out.opt_state},
                                     store.default_is_sketch)["opt_state"]
        after = O.state_bytes(folded)
        print(f"[2] sketch fold: optimizer state {before / 2**20:.2f} MiB "
              f"-> {after / 2**20:.2f} MiB")

        # continue training with the folded state (width halved: a new
        # hparams view); the fold keeps every estimate's sum
        hp2 = O.SketchHParams(compression=HP.compression * 2,
                              width_multiple=HP.width_multiple // 2 or 8,
                              backend="auto")
        step2 = make_step(O.countsketch_adam(1e-3, policy=POL, hparams=hp2))
        st2 = {"step": out.opt_state["step"], "m": folded["m"],
               "v": folded["v"]}
        p2, losses = out.params, []
        for i in range(60, 70):
            b = {k: torch.as_tensor(np.asarray(v), device=dev)
                 for k, v in data.batch(i).items()}
            p2, st2, m = step2(p2, st2, b)
            losses.append(float(m["loss"]))
        print(f"[2] trained 10 more steps on the folded state, "
              f"loss {losses[-1]:.3f}: no reset, no divergence")
        if not np.all(np.isfinite(losses)):
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
