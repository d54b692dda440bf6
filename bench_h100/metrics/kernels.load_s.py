"""kernels.load_s: the kernels' libraries built (nvcc) or loaded (dlopen),
the program's `pir.kernel_load` span, in total."""

from program_spans import total_s


def read(ctx):
    return total_s("pir.kernel_load")
