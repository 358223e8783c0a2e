"""Traced ray segments per pixel sample: the engine's ``stats``
(``segments``, the closest-hit rays of every bounce, plus
``shadow_segments``) over the samples of the frames that counted them.
Nothing where the loop's entry takes no ``stats``."""


def read(run):
    c = run.get("counts")
    if not c or "segments" not in c:
        return None
    return (c["segments"] + c["shadow_segments"]) / c["samples"]
