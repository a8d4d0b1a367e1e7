"""File formats, flow colouring and quality metrics shared by the port's
entry points."""
