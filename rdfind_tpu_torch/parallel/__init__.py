"""The multi-device layer of the port: the rank mesh over ``torch.distributed``
(``mesh``), the launcher that spawns one process per rank (``launch``) and the
fixed-capacity bucket exchanges (``exchange``)."""
