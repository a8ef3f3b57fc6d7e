"""The work of one DLGM SVI step as the algorithm needs it, whatever
computes it: 5DH + 9HZ multiply-adds a row (encoder and decoder forward,
the decoder's input and weight gradients, the encoder's weight
gradients; the input's gradient is not needed), and the batch's rows and
the parameters with both Adam moments read and written once."""

KERNELS = ("pack_kernel", "row_kernel", "wgrad_kernel", "adam_kernel")


def params(d, h, z):
    return d * h + h + 2 * (h * z + z) + z * h + h + h * d + d + 1


def step_flops(d, h, z, b):
    return 2 * b * (5 * d * h + 9 * h * z)


def step_bytes(d, h, z, b):
    return 4 * (b * d + 6 * params(d, h, z))
