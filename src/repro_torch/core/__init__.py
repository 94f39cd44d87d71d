"""The allocator stack of the port: criteria, policies, ledger, epoch
engines, the online allocator and the simulator."""
