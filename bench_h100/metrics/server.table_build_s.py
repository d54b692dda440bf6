"""server.table_build_s: every device table the server built (the storage
tables' host scatter and upload), the program's ``pir.table`` span, in total."""

from program_spans import total_s


def read(ctx):
    return total_s("pir.table")
