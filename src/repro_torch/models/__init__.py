"""Dense GQA decoder on the paged SPARQLe serving path: layers, stage
plan, param schema and the paged prefill/decode entry points."""
