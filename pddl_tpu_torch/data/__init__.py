"""Input data of the port (the synthetic language-modeling task)."""
