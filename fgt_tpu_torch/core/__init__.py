"""File formats shared by the port's entry points."""
