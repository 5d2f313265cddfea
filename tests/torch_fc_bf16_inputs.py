"""bf16 'fc' training gradients of the port against the JAX package on more
inputs than tests/test_torch_fc_train.py holds (CPU; a few minutes).

    JAX_PLATFORMS=cpu python tests/torch_fc_bf16_inputs.py [name:key ...]

Each argument is a complex of runs/eval_r5_scsrc/prep_cache and a PRNG key
(default: 2zec:5, the test's input, 2zec:11, 3mhw:5 and 3pp0:5). For each,
two copies of the complex's sample go through one training step of the
small 'fc' net (tests/test_torch_fc_train.py's config, weights and draws) in
the JAX package at float32 and bfloat16 and in the port at bfloat16, and the
script prints the relative L2 distance of the port's gradients to the JAX
bf16 step's over all gradients and the control (the JAX step's own bf16-vs-
f32 distance), their ratio, and the worst tensors with their controls. The
test's bounds: a ratio below 0.5 and every tensor within 0.2.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]
import test_torch_fc_train as F  # noqa: E402

from diffbindfr_tpu.data.sample import stack_samples as jax_stack  # noqa: E402
from diffbindfr_torch import train as TTR  # noqa: E402
from diffbindfr_torch.chem.records import load_prep_record  # noqa: E402
from diffbindfr_torch.data.sample import make_sample, stack_samples, to_device  # noqa: E402
from diffbindfr_torch.models import score_net as TSN  # noqa: E402
from diffbindfr_torch.sampler import SamplerConfig  # noqa: E402

CACHE = os.path.join(os.path.dirname(F.REC))
DEFAULT = ("2zec:5", "2zec:11", "3mhw:5", "3pp0:5")


def leaf_names(tree, pre="") -> list:
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{pre}/{k}")]
    return [pre]


def run(name: str, key: int) -> float:
    tp = TSN.init_params(torch.Generator().manual_seed(1), F._tcfg("float32"))
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)
    rec = load_prep_record(os.path.join(CACHE, f"{name}_r12.rec.pkl"))
    s = make_sample(rec["lig"], rec["pocket"])
    jb = jax.tree.map(jnp.asarray, jax_stack([s, s]))
    tb = to_device(stack_samples([s, s]), "cpu")
    jkey = jax.random.PRNGKey(key)
    (_, g32), (_, g16) = (F._jax_step(jp, tp, jb, jkey, dt) for dt in ("float32", "bfloat16"))
    _, tg = TTR.loss_and_grads(tp, tb, F.jax_noise(jkey, tb), F._tcfg("bfloat16"),
                               SamplerConfig(), TTR.TrainConfig(), use_kernels=False)
    tg = [g.double().numpy() for g in tg]
    err, ctl = F._l2(tg, g16), F._l2(g32, g16)
    rows = sorted(((F._l2([a], [b]), F._l2([c], [b]), n)
                   for n, a, b, c in zip(leaf_names(tp), tg, g16, g32)
                   if b.size and np.abs(b).max() > 0), reverse=True)
    print(f"{name} key {key}: relative L2 to JAX bf16 {err:.4f}, control {ctl:.4f}, ratio "
          f"{err / ctl:.3f}; worst tensors: "
          + ", ".join(f"{n} {e:.3f} (control {c:.3f})" for e, c, n in rows[:3]), flush=True)
    return err / ctl


if __name__ == "__main__":
    torch.set_num_threads(1)
    for arg in sys.argv[1:] or DEFAULT:
        n, k = arg.split(":")
        run(n, int(k))
