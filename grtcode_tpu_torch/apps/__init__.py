"""Front-end applications (port of grtcode_tpu/apps): CIRC, RFMIP-IRF,
ERA5.  Each ``main(argv=None, *, device=None)`` runs on ``cuda:N`` (``-d
N``, ``cuda:0`` by default) unless the caller passes ``device``."""
