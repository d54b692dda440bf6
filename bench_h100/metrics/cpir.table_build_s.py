"""cpir.table_build_s: every device table the server built (here the cPIR
exponent matrix from the table), the program's ``pir.table`` span, in total."""

from program_spans import total_s


def read(ctx):
    return total_s("pir.table")
