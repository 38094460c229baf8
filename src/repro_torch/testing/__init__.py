"""Test support of the port: deterministic fault injection
(``repro_torch.testing.faults``).  Production modules call the no-op
``faults.fire`` hook; only the fault tests arm it."""
