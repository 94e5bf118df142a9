"""Resilience of the port: fault injection (:mod:`.faults`), retry
policies (:mod:`.retry`), the fit's numerical guardrails
(:mod:`.guardrails`), preemption (:mod:`.preempt`) and elastic training
over a mesh of shards (:mod:`.elastic`)."""
