"""Runtime control logic of the port (port of ``repro.runtime``): so far the
serving side of fault tolerance (:mod:`repro_torch.runtime.fault_tolerance`)."""
