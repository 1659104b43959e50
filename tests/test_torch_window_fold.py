"""The window_fold kernel's plain version against the Pallas kernel it
replaces (`window_fold_pallas`, interpret mode) and the host bigint fold.

Interpret mode costs half a minute whatever the size, so this test has a
file of its own (the suite distributes whole files over workers).  Window
sums are numpy-seeded multiples of the generator with an identity row;
coordinates must match bit for bit (tolerance zero), totals as group
elements.
"""

import numpy as np
import torch

from zkvm_tpu.curves.g1 import G1Affine, G1Projective
from zkvm_tpu.ops import g1_ops as rg1
from zkvm_tpu.ops import msm as rmsm
from zkvm_tpu.ops import pallas_field
from zkvm_tpu_torch.ops import g1_ops, kernels
from zkvm_tpu_torch.ops import limb_field as lf

torch.set_num_threads(1)


def _points(n, seed):
    rng = np.random.default_rng(seed)
    g = G1Projective.generator()
    a = g * int(rng.integers(1, 1 << 62))
    s = g * int(rng.integers(1, 1 << 62))
    out = []
    for _ in range(n):
        out.append(a)
        a = a + s
    return G1Projective.batch_normalize(out)


def test_window_fold_plain_matches_pallas_and_host():
    """Horner fold of [S*W] window sums: bit-identical to the TPU kernel in
    interpret mode, and the host bigint fold's group elements."""
    c, w_count, n_sets = 2, 4, 3
    pts = _points(w_count * n_sets, 4)
    pts[6] = G1Affine.identity()
    ref = rg1.affine_to_device(pts)
    sums = tuple(np.ascontiguousarray(np.asarray(t).T[:, :, None])
                 for t in ref)  # [S*W, 24, 1]
    want = np.asarray(pallas_field.window_fold_pallas(
        c, w_count, n_sets, *sums, interpret=True))
    port_sums = tuple(lf.from_reference(t, lf.FQ, "cpu") for t in sums)
    got = kernels.window_fold(c, w_count, n_sets, *port_sums)
    assert (lf.to_reference(got, lf.FQ) == want).all()
    host = rmsm._host_window_fold(list(sums), c, w_count, n_sets,
                                  [1] * n_sets)
    for s_i in range(n_sets):
        point = tuple(got[k][:, s_i:s_i + 1] for k in range(3))
        assert (g1_ops.device_to_projective(point).to_affine().to_bytes()
                == host[s_i].to_affine().to_bytes())
