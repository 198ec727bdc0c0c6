"""Share of the device-path blocks' positions that the host re-searched
(the refine), from the program's counters ``n_refine_positions`` and
``n_positions``, in %."""


def read(ctx):
    if not ctx.stats or not ctx.stats.get("n_positions"):
        return None
    return (100.0 * ctx.stats.get("n_refine_positions", 0)
            / ctx.stats["n_positions"])
