"""One reader a metric, found by the metric's name up to its first dot
(``mfu.vit_train`` is read by ``mfu.py``). A reader has ``read(ctx)``,
which returns the value or None where it finds nothing to read, and may
list in ``WRAPS`` the program functions whose calls it needs as ranges
in a traced run: ``[(key, module, attribute, bound_fn)]``."""
