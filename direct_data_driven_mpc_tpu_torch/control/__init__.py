"""Controller, closed-loop result type and the condensed engine."""
