"""Applications built on the port (the LWE demo)."""
