"""Cost models of the port (roofline terms priced on the H100)."""
