"""Grounding datasets: HowTo100M / iGround, VidSTG, ActivityNet-Entities."""
