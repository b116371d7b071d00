"""Runtime control logic of the port (port of ``repro.runtime``): fault
tolerance for training and serving (:mod:`repro_torch.runtime.fault_tolerance`)."""
