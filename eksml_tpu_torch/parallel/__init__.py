"""Topology descriptors of the port (one process, one device until\nmulti-GPU, ROADMAP.md Queue 1 item 4)."""
