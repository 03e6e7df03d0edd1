"""Launch helpers of the port, counterpart of ``repro/launch``: the mesh
constructors (``mesh.py``), the meta-device cell specs (``specs.py``), the
multi-pod dry-run on a fake process group (``dryrun.py``) and the perf
hillclimb loop over it (``hillclimb.py``)."""
