"""Model code of the port: blocks and the LM assembly."""
