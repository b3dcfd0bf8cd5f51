"""GlimpsePrune's visual-importance predictor (AttnFuser)."""
