"""Share of the wavefront pool's slots that held a live path: the
engine's ``stats`` (``segments``, the live slots entering each bounce,
over ``slots``, the pool's slots times its iterations) of the frames that
counted them, %. Nothing where the engine counts no slots (the
megakernel)."""


def read(run):
    c = run.get("counts")
    if not c or not c.get("slots"):
        return None
    return 100.0 * c["segments"] / c["slots"]
