"""Scene generators: each configuration's ``scene`` names a module here
with ``scene_data(config)`` (the scene both sides are handed: geometry,
materials, camera) and ``build_port(data, device)`` (the port's Scene of
it); and either ``triangles(data)`` (the flat triangle arrays the
harness's flat reference traces) or ``reference(data, config, device,
dtype)`` (a reference of its own with ``check.Reference``'s interface,
``check.reference_of``)."""
