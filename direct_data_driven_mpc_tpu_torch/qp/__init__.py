"""Static QP spec, assembly and the affine solution operator (host,
float64 numpy)."""
