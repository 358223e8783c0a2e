"""Placements a traced ray segment enters in the two-level instanced
walk: the engine's ``stats`` (``placements_entered``, placement leaves of
the top tree a ray pierced and walked, over ``segments`` plus
``shadow_segments``, the closest-hit and shadow rays) of the frames that
counted them. Nothing where the program counts no placements (another
route, or a program without the counter)."""


def read(run):
    c = run.get("counts")
    if not c or "placements_entered" not in c:
        return None
    rays = c["segments"] + c["shadow_segments"]
    return c["placements_entered"] / rays if rays else None
