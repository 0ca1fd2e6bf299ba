"""EP-MCMC across devices and processes: the combine step and the proof
that sampling moves nothing between chain groups
(:mod:`repro_torch.distributed.epmcmc`)."""
