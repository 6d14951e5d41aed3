"""Distributed layer of the port: the degree-sharded four-step NTT over
torch.distributed ranks (ntt_dist.py) and the process-group / mesh
conveniences (api.py)."""
