"""The work of one leapfrog of the DLGM's local posterior per chain: the
potential's decoder forward and its gradient, 2 nb (Z H + H D)
multiply-adds (z W1, a W2 forward; the residual back through W2 and W1),
and the chain's state, weights and rows read once."""

KERNELS = ("dlgm_nuts_kernel",)


def leapfrog_flops(nb, z, h, d):
    return 2 * 2 * nb * (z * h + h * d)


def leapfrog_bytes(nb, z, h, d):
    return 4 * 3 * nb * z
