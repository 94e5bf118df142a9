"""Resilience of the port: fault injection (:mod:`.faults`), retry
policies (:mod:`.retry`) and the fit's numerical guardrails
(:mod:`.guardrails`)."""
