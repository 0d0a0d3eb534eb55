"""Procedural city (port of `3dworld_tpu/city/`): plots, roads, buildings,
floorplans, room content, traffic, building people and the fused city
frame."""
