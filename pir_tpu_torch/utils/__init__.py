def pad_tile(seq, target: int) -> list:
    """Pad a non-empty sequence to exactly `target` items by tiling it.

    The batch paths pad tail chunks up to a fixed batch size; tiling
    works even when the sequence is shorter than the pad needed. The
    first len(seq) items are the originals in order, so callers slice
    results with [:take].
    """
    reps = -(-target // len(seq))
    return (list(seq) * reps)[:target]
