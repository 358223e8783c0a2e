"""Host seconds of the port's ``SceneBuilder.build`` in set-up (the BVH,
the clusters, their trees and pages, the upload), ended by a synchronise."""


def read(run):
    return run["scene_build_s"]
