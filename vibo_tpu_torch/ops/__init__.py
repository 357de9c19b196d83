"""Numerical ops of the port: the int8 response code, links, distributions,
likelihood, objectives, and the kernels (`pallas_encoder`, `pallas_elbo`,
named after their TPU counterparts) with their build (`_build`)."""
