"""Resilience of the port: fault injection (:mod:`.faults`), retry
policies (:mod:`.retry`), the fit's numerical guardrails
(:mod:`.guardrails`) and preemption (:mod:`.preempt`)."""
