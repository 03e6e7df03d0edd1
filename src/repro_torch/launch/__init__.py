"""Launch helpers of the port, counterpart of ``repro/launch``: the mesh
builders (``launch/mesh.py``). The reference's ``specs.py``,
``dryrun.py`` and ``hillclimb.py`` wait for the port of the roofline."""
