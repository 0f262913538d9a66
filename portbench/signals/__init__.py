"""Signal generators, one module a kind, each with ``make(spec, *, batch,
n_samples, n_steps, gen, device, dictionary)`` returning (batch, 1,
n_samples) float32 drawn from ``gen`` alone."""
