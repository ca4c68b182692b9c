"""Human trajectory data: loading, cleaning and the BC tensors (port of
`overcooked_ai_tpu.human_data`)."""
