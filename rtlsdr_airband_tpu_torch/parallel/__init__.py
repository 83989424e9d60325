"""Multi-device execution: the ('time', 'chan') mesh of torch devices
(``sharding``) and multi-process runs over torch.distributed
(``multihost``)."""
