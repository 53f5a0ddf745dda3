"""Pipeline stages: frame front-end, map state, tracking, system facade."""
