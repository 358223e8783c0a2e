"""Scene generators: each configuration's ``scene`` names a module here
whose ``scene_arrays(config)`` gives the triangles, materials and camera
that both the port and the reference are handed."""
