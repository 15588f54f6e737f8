"""Process identity for the port's fleet-tagged traces
(:mod:`repro_torch.distributed.context`)."""
